"""Beluga serving engine on one device (port of the serving surface of
expecto_tpu/parallel/runner.py).

- the host ships compact base codes: 2 bits per base with N bases in a
  sparse (row, col) sideband, or 4 bits per base for N-dense chunks; the
  device unpacks them to int8 codes, and conv0 gathers its weights by code
  (ops/conv0.py): no float one-hot tensor is built on any serving route;
- the conv stack runs once per span and pool-2 phase (ops/spans.py), every
  conv on a hand-written CUDA kernel (ops/conv0.py, ops/conv8.py);
- reverse complement is taken in code space on the device (flip, c -> 3 - c:
  ``rc_codes``), and forward/RC predictions are averaged there;
- the h5 contract (``predict_span_pairs_diff``, ``predict_span_pair_diffs_only``)
  runs a chunk's ref and alt spans through the conv stack as one batch and
  fetches (ref, diff) per orientation: diff = alt - ref is taken in fp32 on
  the device, and the host rebuilds alt = ref + diff in fp32;
- the decay-basis projection and all stacked tissue models run on the device
  as one matmul, and only per-model scalars come back, as (REF, SED): SED =
  ALT - REF is taken in fp32 on the device before the cast to the fetch
  dtype, and the host rebuilds ALT = REF + SED in fp32;
- the gene path (``predict_spans_project``) applies the (10, 200) decay
  weights to the fwd/RC-averaged predictions of each 41,800-bp span on the
  device, in fp32, and fetches only the (N, 20,020) features;
- the consensus cohort path (``project_spans_backbone_patch``) runs the conv
  stack once over a gene's backbone span, in both orientations, and per
  sample only over the 704-base sub-spans around its diff ranges, spliced
  into copies of the backbone's conv6 buffers, before the same dense layers
  and projection.

Chunks are pipelined, as the JAX runner pipelines them (``_run_pipelined``):
up to ``pipeline_depth`` chunks are in flight, and ``FETCH_WORKERS`` threads
take each chunk's result to the host. On a CUDA device every host array a
chunk needs goes up from pinned memory without blocking, compute stays on the
caller's current stream, and each result comes back on a side stream into a
pinned buffer (``_up``, ``_fetch``); the workers wait on that copy's event and
do numpy work only. On the CPU the chunks compute in the calling thread and the
workers write them out.

While a profiler records, the runner's spans (``utils/profiling.py``) mark
each public method call (``runner.<method>``), its host work before the
first chunk (``runner.plan``), each step of its chunk generator, which
packs and sends up that chunk (``runner.produce``), each chunk from the
start of its production to the end of its landing's wait
(``runner.in_flight``), the caller blocked on the oldest landing
(``runner.wait``) and a worker writing a chunk out (``runner.write``), with
rows, bytes up, bytes down and ``pack4`` (a chunk on the 4-bit wire) as
counts.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..genome.encode import reverse_complement_codes
from ..models.beluga import beluga_forward
from ..models.convert import params_from_jax
from ..ops.conv0 import onehot_from_codes, rc_codes  # noqa: F401 (onehot_from_codes: public, as in the JAX runner)
from ..ops.spans import (
    beluga_forward_spans,
    conv6_patch_ranges,
    conv6_phases,
    conv6_phases_patch,
    conv6_phases_patch_sites,
    fc1_delta_from_phases,
    fc1_pre_from_phases,
    fc_from_phases,
    fc_head,
)
from ..utils import profiling


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack two int8 base codes (0..4) per byte for host->device transfer.
    Pads odd lengths with code 4 (N)."""
    n, l = codes.shape
    if l % 2:
        codes = np.concatenate([codes, np.full((n, 1), 4, np.int8)], axis=1)
    pairs = codes.reshape(n, (l + l % 2) // 2, 2).astype(np.uint8)
    return pairs[:, :, 0] * 16 + pairs[:, :, 1]


def unpack_codes(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Device-side inverse of :func:`pack_codes` -> (N, length) int8 codes."""
    codes = torch.stack([packed // 16, packed % 16], dim=-1).reshape(packed.shape[0], -1)
    return codes[:, :length].to(torch.int8)


def pack_codes2(codes: np.ndarray):
    """Pack four base codes (0..4) per byte (2 bits/base); N bases (code 4)
    ride a sparse (rows, cols) sideband. Returns (packed (N, ceil(L/4))
    uint8, rows, cols)."""
    n, l = codes.shape
    # one flat scan: a 2-D np.nonzero takes several times as long
    rows, cols = np.divmod(np.flatnonzero(codes == 4), l)
    c = np.zeros((n, l + (-l) % 4), np.uint8)
    np.bitwise_and(codes, 3, out=c[:, :l], casting="unsafe")  # N (4) -> 0
    # four codes a little-endian 32-bit word, the first in its low byte:
    # each code's two bits shifted into the low byte, the first highest
    w = c.view("<u4")
    packed = ((w << 6) | (w >> 4) | (w >> 14) | (w >> 24)).astype(np.uint8)
    return packed, rows.astype(np.int32), cols.astype(np.int32)


def unpack_codes2(packed: torch.Tensor, length: int, n_rows: torch.Tensor, n_cols: torch.Tensor) -> torch.Tensor:
    """Device-side inverse of :func:`pack_codes2`. Sideband entries outside
    the (N, length) block are dropped, as the JAX scatter's ``mode="drop"``
    drops them (``index_put_`` would raise on them)."""
    b = packed
    n = b.shape[0]
    c = torch.stack([(b >> 6) & 3, (b >> 4) & 3, (b >> 2) & 3, b & 3], dim=-1)
    # one spare element past the end takes the dropped entries, and the 4
    # goes in as a fill value: a boolean mask, or a value tensor copied from
    # the host, would make the host wait for the device
    flat = torch.empty(n * length + 1, dtype=torch.int8, device=b.device)
    flat[: n * length] = c.reshape(n, -1)[:, :length].reshape(-1)
    keep = (n_rows >= 0) & (n_rows < n) & (n_cols >= 0) & (n_cols < length)
    flat.index_fill_(0, torch.where(keep, n_rows.long() * length + n_cols.long(), n * length), 4)
    return flat[: n * length].view(n, length)


def rc_onehot(x: torch.Tensor) -> torch.Tensor:
    """Reverse complement of a one-hot batch: flip positions and channels
    (valid under AGCT channel order). The serving routes take it in code
    space instead (``rc_codes``)."""
    return torch.flip(x, (1, 2))


def fp32_wire_kw(runner) -> dict:
    """``predict_codes`` kwargs forcing an fp32 wire on runners that would
    otherwise fetch fp16 (host-side ALT - REF differencing must never ride
    independently fp16-rounded sides). Duck-typed runners without an
    ``out_dtype`` attribute get no extra kwarg."""
    if np.dtype(getattr(runner, "out_dtype", np.float32)) != np.float32:
        return {"out_dtype": np.float32}
    return {}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no GPU raises
    instead of running silently on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA GPU is available; pass device='cpu' to run on the CPU"
        )
    return device


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.float16 if np.dtype(np_dtype) == np.float16 else torch.float32


def _spanned(method):
    """``method`` inside a ``runner.<name>`` span."""
    return profiling.spanned("runner." + method.__name__)(method)


def _produced(jobs):
    """Each job of ``jobs`` with its chunk's ``runner.in_flight`` span,
    begun before the job is produced (one ``runner.produce`` step). The
    span begun for the step that finds ``jobs`` done is never ended, so
    never recorded."""
    it = iter(jobs)
    while True:
        flight = profiling.begin("runner.in_flight")
        with profiling.span("runner.produce") as produce:
            job = next(it, None)
        if job is None:
            return
        if flight:
            flight.add(rows=job[1])
            produce.add(rows=job[1])
        yield (*job, flight)


def _pinned_like(y: torch.Tensor) -> torch.Tensor:
    """A pinned host tensor of ``y``'s shape and dtype from torch's caching
    host allocator: a non-blocking copy into it records an event on its
    block, and the block is handed out again only after that event and
    after the tensor, and every numpy view of it, is gone."""
    return torch.empty(y.shape, dtype=y.dtype, pin_memory=True)


class _Landing:
    """One chunk's results on their way to the host: the host tensors and,
    on a CUDA device, the event recorded after their copies."""

    def __init__(self, host: tuple, copied):
        self.host, self.copied = host, copied

    def wait(self) -> tuple:
        """The results as numpy arrays, once their copies have finished."""
        if self.copied is not None:
            self.copied.synchronize()
        return tuple(t.numpy() for t in self.host)


class BelugaRunner:
    """Beluga serving engine on one device.

    Args:
        params: Beluga pytree (numpy arrays, as models/convert.load_params_npz
            returns, or tensors).
        batch_size: spans (windows on the window path) per device call,
            divided by the number of shift offsets on the span paths.
        device: ``"cuda"`` (default) or ``"cpu"``; CUDA with no GPU raises.
        compute_dtype: torch.float32 (parity: TF32 is switched off) or
            torch.bfloat16 (production).
        out_dtype: dtype fetched to host (np.float32 parity / np.float16
            production).
        pipeline_depth: most chunks in flight before the oldest one's
            result is written out (at least 1).
    """

    #: per-chunk N-sideband budget of the 2-bit wire; a denser chunk ships
    #: 4 bits per base instead (N-padded contig-edge spans hit this)
    PACK2_SIDE_BUDGET = 16384

    #: threads that wait for a chunk's results and write them out (the fp32
    #: cast, ALT = REF + SED, the h5 row layout, a caller's sink): three, as
    #: in the JAX runner. On an H100 one writer (the in-order path of
    #: ``_run_pipelined``) kept the card as busy at the CLIs' depths
    FETCH_WORKERS = 3

    def __init__(self, params, batch_size: int = 1024, *, device="cuda", compute_dtype=torch.float32,
                 out_dtype=np.float32, pipeline_depth: int = 4):
        self.device = resolve_device(device)
        self.batch_size = max(int(batch_size), 1)
        self.out_dtype = np.dtype(out_dtype)
        self.pipeline_depth = max(int(pipeline_depth), 1)
        if compute_dtype == torch.float32:
            # parity mode: TF32 off in every torch call; the fc1 kernel's
            # three-pass TF32 split (ops/fc1.py) is held to fp32's limits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        self.params = params_from_jax(params, device=self.device, dtype=compute_dtype)
        self._wire = _torch_dtype(self.out_dtype)
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    # ---- pipelined execution ------------------------------------------------

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device. On CUDA it is staged in pinned memory from
        torch's caching host allocator and sent up without blocking on the
        current stream; the copy records an event on the block, and the
        allocator hands the block out again only after that event."""
        src = torch.from_numpy(np.ascontiguousarray(a))
        profiling.count(bytes_up=src.nbytes)
        if self._copy_stream is None:
            return src
        return src.pin_memory().to(self.device, non_blocking=True)

    def _fetch(self, *ys: torch.Tensor) -> _Landing:
        """``ys`` on their way to the host. On CUDA the copy stream waits for
        the chunk's last kernel on the current stream and copies each result
        into a pinned host tensor (``_pinned_like``)."""
        if self._copy_stream is None:
            return _Landing(ys, None)
        ys = [y.contiguous() for y in ys]
        computed = torch.cuda.Event()
        computed.record(torch.cuda.current_stream(self.device))
        self._copy_stream.wait_event(computed)
        host = []
        with torch.cuda.stream(self._copy_stream):
            for y in ys:
                h = _pinned_like(y)
                h.copy_(y, non_blocking=True)
                y.record_stream(self._copy_stream)  # the allocator keeps y until the copy ran
                host.append(h)
        copied = torch.cuda.Event(blocking=True)  # a waiting worker sleeps instead of spinning on a core
        copied.record(self._copy_stream)
        return _Landing(tuple(host), copied)

    def _run_pipelined(self, jobs, write) -> None:
        """Drain a stream of ``(start, real, landing)`` jobs with up to
        ``pipeline_depth`` of them in flight: ``write(start, real, host)``
        gets each job's results as numpy arrays (``_Landing.wait``) on a
        pool of ``FETCH_WORKERS`` threads, possibly out of order, once per
        job. Writers must touch disjoint rows. Exceptions propagate in
        submission order, after the jobs already submitted have finished.
        With one worker the writes run in this thread, in order. Either way,
        at depth 1 each write returns before the next job is produced."""
        method = profiling.current()

        def land(start, real, landing, flight, write_span):
            host = landing.wait()
            flight.end()
            with write_span("runner.write", rows=real) as w:
                if w:
                    w.add(bytes_down=sum(a.nbytes for a in host))
                write(start, real, host)

        if self.FETCH_WORKERS <= 1:
            in_flight = deque()
            for job in _produced(jobs):
                in_flight.append(job)
                if len(in_flight) >= self.pipeline_depth:
                    land(*in_flight.popleft(), profiling.span)
            for job in in_flight:
                land(*job, profiling.span)
            return

        with ThreadPoolExecutor(max_workers=self.FETCH_WORKERS) as ex:
            pending = deque()
            for job in _produced(jobs):
                pending.append(ex.submit(land, *job, method.child))
                if len(pending) >= self.pipeline_depth:
                    with profiling.span("runner.wait"):
                        pending.popleft().result()
            while pending:
                with profiling.span("runner.wait"):
                    pending.popleft().result()

    # ---- host <-> device -------------------------------------------------

    @property
    def _basis_wire_dtype(self):
        # decay-basis weights are in (0, 1]; fp16 transfer loses nothing
        # beyond the production mode's bf16 precision
        return np.float16 if self.out_dtype == np.float16 else np.float32

    @staticmethod
    def _write_ref_sed(REF, ALT, SED):
        """A writer of (REF, SED) wire chunks: SED is stored exactly as the
        device computed it and ALT is rebuilt as REF + SED in fp32."""

        def write(start, real, host):
            ref, sed = (a.astype(np.float32) for a in host)
            REF[start : start + real] = ref
            SED[start : start + real] = sed
            ALT[start : start + real] = ref + sed

        return write

    @staticmethod
    def _write_rows(out):
        """A writer of chunks that fill ``out[start : start + real]``."""

        def write(start, real, host):
            out[start : start + real] = host[0]

        return write

    def _span_rows(self, n_offsets: int) -> int:
        return max(self.batch_size // n_offsets, 1)

    def _pair_rows(self, n_offsets: int) -> int:
        """Pairs per call for the two-span paths: each pair is two spans."""
        return max(self._span_rows(n_offsets) // 2, 1)

    def _chunk_wire(self, codes: np.ndarray):
        """One chunk's host wire and its bits a base: 2, (packed, n_rows,
        n_cols) with the chunk's own N sideband, or 4, (packed,), when the
        chunk holds more N bases than ``PACK2_SIDE_BUDGET``."""
        packed, n_rows, n_cols = pack_codes2(codes)
        if n_rows.size > self.PACK2_SIDE_BUDGET:
            return 4, (pack_codes(codes),)
        return 2, (packed, n_rows, n_cols)

    def _chunk_codes(self, codes: np.ndarray) -> torch.Tensor:
        """One chunk's (N, L) int8 device codes, packed here on the wire
        :meth:`_chunk_wire` chooses; a 4-bit chunk counts ``pack4``. Both
        wires give the device the same codes."""
        bits, wire = self._chunk_wire(codes)
        if bits == 4:
            profiling.count(pack4=1)
            return unpack_codes(self._up(wire[0]), codes.shape[1])
        packed, n_rows, n_cols = (self._up(a) for a in wire)
        return unpack_codes2(packed, codes.shape[1], n_rows, n_cols)

    def _code_chunks(self, span_codes: np.ndarray, rows: int):
        """Yield (start, (real, L) int8 device codes) per chunk of ``rows``
        spans, each chunk packed and sent up as the generator reaches it."""
        for start in range(0, span_codes.shape[0], rows):
            yield start, self._chunk_codes(span_codes[start : start + rows])

    def _pair_chunks(self, ref_spans: np.ndarray, alt_spans: np.ndarray, rows: int):
        """Yield (start, (2 * real, L) device codes interleaved per pair,
        [r0, a0, r1, a1, ...]) per chunk of ``rows`` pairs: both alleles run
        through the conv stack as one batch. Each chunk's pairs are
        interleaved and packed as the generator reaches them."""
        n, span_len = ref_spans.shape
        for start in range(0, n, rows):
            stop = min(start + rows, n)
            inter = np.empty((2 * (stop - start), span_len), dtype=np.int8)
            inter[0::2] = ref_spans[start:stop]
            inter[1::2] = alt_spans[start:stop]
            yield start, self._chunk_codes(inter)

    def _pair_diff_jobs(self, ref_spans, alt_spans, offsets, with_ref: bool):
        """Jobs of (start, real, :meth:`_pair_diff_wire` on its way to the
        host) per chunk of (ref, alt) span pairs; the pairs are interleaved
        and packed here, each chunk produced as the jobs are drawn."""
        offsets = tuple(int(o) for o in offsets)
        chunks = self._pair_chunks(np.asarray(ref_spans, dtype=np.int8), np.asarray(alt_spans, dtype=np.int8),
                                   self._pair_rows(len(offsets)))
        return ((start, codes.shape[0] // 2, self._fetch(self._pair_diff_wire(codes, offsets, with_ref)))
                for start, codes in chunks)

    def _pair_diff_wire(self, codes: torch.Tensor, offsets, with_ref: bool) -> torch.Tensor:
        """h5-contract wire of one interleaved pair chunk: ``(ref, diff)``
        stacked as (P, 2, 2[fwd|rc], S, M), or ``diff`` alone as
        (P, 2[fwd|rc], S, M), at the fetch dtype. ``diff = alt - ref`` is
        taken in fp32 on the device before the cast, so an fp16 wire keeps
        diff's relative precision."""
        p = self._span_preds_fwd_rc(codes, offsets)
        ref, diff = p[0::2], p[1::2] - p[0::2]
        y = torch.stack([ref, diff], dim=1) if with_ref else diff
        return y.to(self._wire)

    @staticmethod
    def _row_chunk_bounds(row_uidx: np.ndarray, n_u: int, rows: int):
        """Row bounds (r0, r1) of each chunk of ``rows`` unique variants, for
        (variant, gene) rows whose nondecreasing ``row_uidx`` maps them onto
        unique variants."""
        return [(int(np.searchsorted(row_uidx, s)), int(np.searchsorted(row_uidx, min(s + rows, n_u))))
                for s in range(0, n_u, rows)]

    def _model_tensors(self, W: np.ndarray, bias: np.ndarray):
        return self._up(np.asarray(W, dtype=np.float32)), self._up(np.asarray(bias, dtype=np.float32))

    @staticmethod
    def _outputs(n: int, k: int):
        return tuple(np.empty((n, k), dtype=np.float32) for _ in range(3))

    # ---- device functions --------------------------------------------------

    def _forward(self, codes: torch.Tensor, with_rc: bool, out: torch.dtype) -> torch.Tensor:
        y = beluga_forward(self.params, codes).float()
        if with_rc:
            y = (y + beluga_forward(self.params, rc_codes(codes)).float()) * 0.5
        return y.to(out)

    def _span_preds_fwd_rc(self, spans: torch.Tensor, offsets) -> torch.Tensor:
        """(N, 2, S, M) fp32 track predictions of an (N, L) int8 span batch,
        forward at [:, 0] and reverse complement at [:, 1]; the RC window of
        offset ``o`` sits at the mirrored offset of the RC span."""
        y = beluga_forward_spans(self.params, spans, offsets).float()
        extra = spans.shape[1] - 2000
        rc_off = tuple(extra - o for o in offsets)
        y_rc = beluga_forward_spans(self.params, rc_codes(spans), rc_off).float()
        return torch.stack([y, y_rc], dim=1)

    def _pair_span_preds(self, spans: torch.Tensor, offsets) -> torch.Tensor:
        """fwd/RC-averaged (N, S, M) fp32 track predictions of an (N, L)
        int8 span batch."""
        p = self._span_preds_fwd_rc(spans, offsets)
        return (p[:, 0] + p[:, 1]) * 0.5

    def _preds_from_ref(self, ref: torch.Tensor, alt_allele: torch.Tensor, offsets, span_len: int, mutpos: int):
        """fwd/RC-averaged (N, S, 2002) predictions for ref and alt from one
        span per variant: the alt span is spliced on the device
        (``alt_allele`` code -1 keeps the reference base), the alt conv
        stack recomputes only the ~20 conv6 frames around the variant, and
        alt's fc1 is ref's plus a delta over those frames."""
        a_len = alt_allele.shape[1]
        patch = ref[:, mutpos : mutpos + a_len]
        alt = ref.clone()
        alt[:, mutpos : mutpos + a_len] = torch.where(alt_allele >= 0, alt_allele, patch)

        extra = span_len - 2000
        rc_offsets = tuple(extra - o for o in offsets)
        phases_f = {(o // 4) % 4 for o in offsets}
        phases_r = {(o // 4) % 4 for o in rc_offsets}
        mut_rc = span_len - mutpos - a_len

        ph_ref_f = conv6_phases(self.params, ref, phases_f)
        ph_ref_r = conv6_phases(self.params, rc_codes(ref), phases_r)
        ph_alt_f = conv6_phases_patch(self.params, ph_ref_f, alt, mutpos, a_len, phases_f)
        ph_alt_r = conv6_phases_patch(self.params, ph_ref_r, rc_codes(alt), mut_rc, a_len, phases_r)

        ranges_f = conv6_patch_ranges(mutpos, a_len, phases_f, {p: b.shape[1] for p, b in ph_ref_f.items()})
        ranges_r = conv6_patch_ranges(mut_rc, a_len, phases_r, {p: b.shape[1] for p, b in ph_ref_r.items()})
        h_ref_f = fc1_pre_from_phases(self.params, ph_ref_f, offsets)
        h_ref_r = fc1_pre_from_phases(self.params, ph_ref_r, rc_offsets)
        d_f = fc1_delta_from_phases(self.params, ph_ref_f, ph_alt_f, ranges_f, offsets)
        d_r = fc1_delta_from_phases(self.params, ph_ref_r, ph_alt_r, ranges_r, rc_offsets)

        def preds(h_fwd, h_rc):
            y = fc_head(self.params, h_fwd).float()
            y_rc = fc_head(self.params, h_rc).float()
            return (y + y_rc) * 0.5

        return preds(h_ref_f, h_ref_r), preds(h_ref_f + d_f, h_ref_r + d_r)

    def _score_spans_chunk(self, ref: torch.Tensor, alt_allele: torch.Tensor, basis, W, bias, offsets,
                           span_len: int, mutpos: int):
        """(REF, SED) of one serving chunk of :meth:`score_variant_spans_packed`
        from its (N, L) device codes: :meth:`_preds_from_ref`, then
        :meth:`_ref_sed` (the JAX runner's ``_score_spans_packed2`` after its
        unpack)."""
        p_ref, p_alt = self._preds_from_ref(ref, alt_allele, offsets, span_len, mutpos)
        return self._ref_sed(p_ref, p_alt, basis, W, bias)

    def _backbone_phases(self, backbone: torch.Tensor, offsets):
        """(1, L) int8 backbone codes -> (fwd, rc) conv6 phase-buffer dicts
        of the windows at ``offsets``, computed once per call and shared by
        every patched chunk; the RC window of offset ``o`` is at
        ``L - 2000 - o`` of the RC span."""
        rc_offsets = tuple(backbone.shape[1] - 2000 - o for o in offsets)
        ph_f = conv6_phases(self.params, backbone, {(o // 4) % 4 for o in offsets})
        ph_r = conv6_phases(self.params, rc_codes(backbone), {(o // 4) % 4 for o in rc_offsets})
        return ph_f, ph_r

    def _ref_sed(self, p_ref, p_alt, basis, W, bias):
        """(REF, SED) at the wire dtype from (R, S, M) predictions, an
        (S, R, B) decay basis and stacked (B*M, K) models: per-row decay
        features, every model in one matmul, SED differenced in fp32."""

        def feats(p):
            return torch.einsum("srb,rsm->rbm", basis.float(), p).reshape(p.shape[0], -1)

        REF = feats(p_ref) @ W + bias
        ALT = feats(p_alt) @ W + bias
        return REF.to(self._wire), (ALT - REF).to(self._wire)

    def _project(self, preds: torch.Tensor, pos_weights: torch.Tensor) -> torch.Tensor:
        """(G, S, M) fp32 predictions against (B, S) decay weights -> (G,
        B*M) features, contracted in fp32 on the device, at the wire dtype
        (an fp16 wire rounds at about 5e-4 relative; the host stores fp32)."""
        feats = torch.einsum("bs,nsm->nbm", pos_weights, preds).reshape(preds.shape[0], -1)
        return feats.to(self._wire)

    # ---- public API ----------------------------------------------------------

    @_spanned
    @torch.inference_mode()
    def predict_codes(self, codes: np.ndarray, *, average_rc: bool = False, out_dtype=None) -> np.ndarray:
        """Run Beluga over int8 base codes (N, 2000) -> (N, 2002).

        ``average_rc=True`` averages forward and reverse-complement
        predictions on the device. ``out_dtype`` overrides the runner's
        fetch dtype for this call."""
        with profiling.span("runner.plan", rows=len(codes)):
            codes = np.asarray(codes, dtype=np.int8)
            fetch = self.out_dtype if out_dtype is None else np.dtype(out_dtype)
            out = np.empty((codes.shape[0], 2002), dtype=fetch)

        def jobs():
            for start in range(0, codes.shape[0], self.batch_size):
                chunk = self._up(codes[start : start + self.batch_size])
                yield start, chunk.shape[0], self._fetch(self._forward(chunk, average_rc, _torch_dtype(fetch)))

        self._run_pipelined(jobs(), self._write_rows(out))
        return out

    @_spanned
    def predict_codes_fwd_rc_concat(self, codes: np.ndarray) -> np.ndarray:
        """Reference-layout output: rows [0:N] forward, [N:2N] reverse
        complement (the encodeSeqs concat order of the reference's
        expecto_utils.py)."""
        codes = np.asarray(codes, dtype=np.int8)
        return self.predict_codes(np.concatenate([codes, reverse_complement_codes(codes)], axis=0))

    @_spanned
    @torch.inference_mode()
    def predict_span_codes(self, span_codes: np.ndarray, offsets, *, rc_mode: str = "none") -> np.ndarray:
        """Span-amortized forward: (N, span_len) int8 codes -> per-window
        predictions for windows span[o : o+2000] at each offset, at the
        fetch dtype.

        rc_mode: 'none' -> (N, O, 2002); 'average' -> fwd/RC averaged
        (N, O, 2002); 'concat' -> (N, 2, O, 2002) with fwd at [:, 0], RC at
        [:, 1]."""
        if rc_mode not in ("none", "average", "concat"):
            raise ValueError(rc_mode)
        with profiling.span("runner.plan", rows=len(span_codes)):
            span_codes = np.asarray(span_codes, dtype=np.int8)
            offsets = tuple(int(o) for o in offsets)
            n = span_codes.shape[0]
            shape = (n, 2, len(offsets), 2002) if rc_mode == "concat" else (n, len(offsets), 2002)
            out = np.empty(shape, dtype=self.out_dtype)
            chunks = self._code_chunks(span_codes, self._span_rows(len(offsets)))

        def jobs():
            for start, codes in chunks:
                if rc_mode == "none":
                    y = beluga_forward_spans(self.params, codes, offsets).float()
                else:
                    y = self._span_preds_fwd_rc(codes, offsets)
                    if rc_mode == "average":
                        y = (y[:, 0] + y[:, 1]) * 0.5
                yield start, codes.shape[0], self._fetch(y.to(self._wire))

        self._run_pipelined(jobs(), self._write_rows(out))
        return out

    @_spanned
    @torch.inference_mode()
    def predict_spans_project(self, span_codes: np.ndarray, offsets, pos_weights: np.ndarray) -> np.ndarray:
        """Gene path on the device: (N, span_len) int8 span codes -> shared
        conv stack over each span's windows at ``offsets``, forward and
        reverse complement averaged in fp32, the (B, n_offsets) decay
        weights applied -> (N, B*2002) float32 features. Spans ship 2-bit
        packed, or 4-bit for N-dense chunks."""
        with profiling.span("runner.plan", rows=len(span_codes)):
            span_codes = np.asarray(span_codes, dtype=np.int8)
            offsets = tuple(int(o) for o in offsets)
            pos_weights = np.asarray(pos_weights, dtype=np.float32)
            out = np.empty((span_codes.shape[0], pos_weights.shape[0] * 2002), dtype=np.float32)
            pw = self._up(pos_weights)
            chunks = self._code_chunks(span_codes, self._span_rows(len(offsets)))

        def jobs():
            for start, codes in chunks:
                yield start, codes.shape[0], self._fetch(self._project(self._pair_span_preds(codes, offsets), pw))

        self._run_pipelined(jobs(), self._write_rows(out))
        return out

    @_spanned
    @torch.inference_mode()
    def project_spans_backbone_patch(self, backbone_span, sample_spans, starts_f, starts_r, offsets,
                                     pos_weights) -> np.ndarray:
        """Cohort gene-path projection with backbone conv6 patching: the conv
        stack runs once over the shared backbone span (both orientations);
        each sample recomputes only the conv6 frames around its own diff
        ranges, from (N·K, PATCH_SUB_LEN) sub-spans of its int8 codes, before the
        dense layers, the fwd/RC average in fp32 and the decay projection
        on the device.

        Args:
            backbone_span: (span_len,) int8 codes of the shared backbone.
            sample_spans: (N, span_len) int8 codes; they ship 2-bit packed,
                or 4-bit for N-dense chunks, in chunks of
                ``_span_rows(len(offsets))`` samples.
            starts_f / starts_r: (N, K, 2) ``(w0, d0)`` range starts for the
                forward and reverse-complement orientations
                (ops/spans.conv6_patch_sites_plan on the forward and the
                mirrored diff positions); K is padded with zeros to a
                multiple of 8. Inactive slots hold 0: a superfluous patch
                recomputes frames from the sample's own bases.
            pos_weights: (B, S) decay basis over the offsets.

        Returns (N, B*2002) float32 features, matching
        ``predict_spans_project(sample_spans, offsets, pos_weights)`` up to
        fp reduction order."""
        with profiling.span("runner.plan", rows=len(sample_spans)):
            backbone_span = np.asarray(backbone_span, dtype=np.int8)
            sample_spans = np.asarray(sample_spans, dtype=np.int8)
            offsets = tuple(int(o) for o in offsets)
            starts_f, starts_r = np.asarray(starts_f, dtype=np.int64), np.asarray(starts_r, dtype=np.int64)
            # K buckets in steps of 8, as the JAX runner compiles one program per
            # bucket: an inactive slot still convolves real bases
            k_pad = -(-max(starts_f.shape[1], starts_r.shape[1], 1) // 8) * 8
            starts_f, starts_r = (np.pad(s, ((0, 0), (0, k_pad - s.shape[1]), (0, 0))) for s in (starts_f, starts_r))
            pos_weights = np.asarray(pos_weights, dtype=np.float32)
            rc_offsets = tuple(sample_spans.shape[1] - 2000 - o for o in offsets)
            phases_f = {(o // 4) % 4 for o in offsets}
            phases_r = {(o // 4) % 4 for o in rc_offsets}
            out = np.empty((sample_spans.shape[0], pos_weights.shape[0] * 2002), dtype=np.float32)
            pw = self._up(pos_weights)
            # the backbone's conv stack goes on the card before the samples
            # are packed
            ph_f, ph_r = self._backbone_phases(self._up(backbone_span[None]), offsets)
            chunks = self._code_chunks(sample_spans, self._span_rows(len(offsets)))

        def jobs():
            for start, codes in chunks:
                stop = start + codes.shape[0]
                pf = conv6_phases_patch_sites(self.params, ph_f, codes, self._up(starts_f[start:stop, :, 0]), phases_f)
                pr = conv6_phases_patch_sites(self.params, ph_r, rc_codes(codes), self._up(starts_r[start:stop, :, 0]),
                                              phases_r)
                y = fc_from_phases(self.params, pf, offsets).float()
                y_rc = fc_from_phases(self.params, pr, rc_offsets).float()
                yield start, stop - start, self._fetch(self._project((y + y_rc) * 0.5, pw))

        self._run_pipelined(jobs(), self._write_rows(out))
        return out

    @_spanned
    @torch.inference_mode()
    def predict_and_project(self, codes: np.ndarray, pos_weights: np.ndarray, n_shifts: int) -> np.ndarray:
        """Gene path per window: (G*S, 2000) window codes, S consecutive rows
        a gene, + (B, S) decay weights -> (G, B*2002) float32 features, fwd/RC
        averaged and projected on the device (the per-window counterpart of
        :meth:`predict_spans_project`)."""
        codes = np.asarray(codes, dtype=np.int8)
        if codes.shape[0] % n_shifts != 0:
            raise ValueError("codes rows must be a multiple of n_shifts")
        with profiling.span("runner.plan", rows=len(codes)):
            pos_weights = np.asarray(pos_weights, dtype=np.float32)
            genes_per_batch = max(self.batch_size // n_shifts, 1)
            n_genes = codes.shape[0] // n_shifts
            out = np.empty((n_genes, pos_weights.shape[0] * 2002), dtype=np.float32)
            pw = self._up(pos_weights)

        def jobs():
            for g0 in range(0, n_genes, genes_per_batch):
                g1 = min(g0 + genes_per_batch, n_genes)
                y = self._forward(self._up(codes[g0 * n_shifts : g1 * n_shifts]), True, torch.float32)
                yield g0, g1 - g0, self._fetch(self._project(y.reshape(g1 - g0, n_shifts, -1), pw))

        self._run_pipelined(jobs(), self._write_rows(out))
        return out

    @_spanned
    @torch.inference_mode()
    def predict_span_pairs_diff(self, ref_spans, alt_spans, offsets, *, sink=None):
        """h5-contract pair forward: (N, span_len) ref/alt spans ->
        (REF, ALT, DIFF), each (2N, n_offsets, 2002) float32 in the
        reference h5 row layout, rows [0:N] forward and [N:2N] reverse
        complement, so a shift's h5 arrays are the slices ``x[:, si]``.

        ``diff = alt - ref`` is computed in fp32 on the device and fetched at
        the runner's wire dtype with ref; the host rebuilds ``alt = ref +
        diff`` in fp32. Ref and alt spans ship 2-bit packed, interleaved per
        variant, and run through the conv stack as one batch.

        With ``sink``, chunks stream instead of filling the three arrays:
        ``sink(start, real, ref, alt, diff)`` receives fp32 arrays of shape
        (real, 2[fwd|rc], S, M) for variant rows [start, start + real), and
        the method returns None. The sink is called from the fetch workers,
        once per chunk, in any order and possibly from several threads at
        once: a sink that writes shared state takes a lock."""
        n = len(ref_spans)
        with profiling.span("runner.plan", rows=n):
            if sink is None:
                REF, ALT, DIFF = (np.empty((2 * n, len(offsets), 2002), dtype=np.float32) for _ in range(3))
            jobs = self._pair_diff_jobs(ref_spans, alt_spans, offsets, with_ref=True)

        def write(start, r, host):
            y = host[0]  # (r, 2[ref|diff], 2[fwd|rc], S, M) at the wire dtype
            if sink is not None:
                ref = y[:, 0].astype(np.float32)
                diff = y[:, 1].astype(np.float32)
                sink(start, r, ref, ref + diff, diff)
                return
            for orient, s0 in ((0, start), (1, n + start)):  # fwd rows, then rc rows
                ref, diff = REF[s0 : s0 + r], DIFF[s0 : s0 + r]
                ref[...] = y[:, 0, orient]  # an fp16 wire converts in place
                diff[...] = y[:, 1, orient]
                np.add(ref, diff, out=ALT[s0 : s0 + r])

        self._run_pipelined(jobs, write)
        return None if sink is not None else (REF, ALT, DIFF)

    @_spanned
    @torch.inference_mode()
    def predict_span_pair_diffs_only(self, ref_spans, alt_spans, offsets, *, sink=None):
        """Legacy-contract pair forward: only ``diff = alt - ref`` leaves the
        device, half the wire of :meth:`predict_span_pairs_diff`, for the
        original-ExPecto h5 format whose single ``pred`` dataset is the diff.

        Returns (2N, n_offsets, 2002) float32 in the [fwd; rc] row layout,
        or streams ``sink(start, real, diff)`` chunks of shape
        (real, 2[fwd|rc], S, M) fp32 and returns None (called as
        :meth:`predict_span_pairs_diff` calls its sink)."""
        n = len(ref_spans)
        with profiling.span("runner.plan", rows=n):
            if sink is None:
                DIFF = np.empty((2 * n, len(offsets), 2002), dtype=np.float32)
            jobs = self._pair_diff_jobs(ref_spans, alt_spans, offsets, with_ref=False)

        def write(start, r, host):
            y = host[0]  # (r, 2[fwd|rc], S, M) at the wire dtype
            if sink is not None:
                sink(start, r, y.astype(np.float32))
                return
            DIFF[start : start + r] = y[:, 0]
            DIFF[n + start : n + start + r] = y[:, 1]

        self._run_pipelined(jobs, write)
        return None if sink is not None else DIFF

    @_spanned
    @torch.inference_mode()
    def score_variant_spans(self, ref_spans, alt_spans, offsets, basis, W, bias):
        """Fused SED serving of explicit (ref, alt) span pairs: (N, span_len)
        spans + (S, N, B) decay basis + stacked model weights (F, K) ->
        (REF, ALT, SED), each (N, K). Both spans ship 2-bit packed,
        interleaved per variant, or 4-bit for N-dense chunks."""
        with profiling.span("runner.plan", rows=len(ref_spans)):
            ref_spans = np.asarray(ref_spans, dtype=np.int8)
            alt_spans = np.asarray(alt_spans, dtype=np.int8)
            offsets = tuple(int(o) for o in offsets)
            n, span_len = ref_spans.shape
            REF, ALT, SED = self._outputs(n, W.shape[1])
            basis_wire = basis.astype(self._basis_wire_dtype, copy=False)
            W_dev, bias_dev = self._model_tensors(W, bias)
            chunks = self._pair_chunks(ref_spans, alt_spans, self._pair_rows(len(offsets)))

        def jobs():
            for start, codes in chunks:
                pair = codes.reshape(-1, 2, span_len)
                basis_t = self._up(basis_wire[:, start : start + pair.shape[0]])
                p_ref = self._pair_span_preds(pair[:, 0], offsets)
                p_alt = self._pair_span_preds(pair[:, 1], offsets)
                yield start, pair.shape[0], self._fetch(*self._ref_sed(p_ref, p_alt, basis_t, W_dev, bias_dev))

        self._run_pipelined(jobs(), self._write_ref_sed(REF, ALT, SED))
        return REF, ALT, SED

    @_spanned
    @torch.inference_mode()
    def score_variant_spans_packed(self, ref_spans, mutpos: int, alt_alleles, offsets, basis, W, bias):
        """Fused SED serving from one span per variant: (N, span_len) ref
        spans + (N, A) alt-allele codes spliced on the device at ``mutpos``
        (-1 keeps the reference base). Spans ship 2-bit packed, or 4-bit for
        N-dense chunks."""
        with profiling.span("runner.plan", rows=len(ref_spans)):
            ref_spans = np.asarray(ref_spans, dtype=np.int8)
            alt_alleles = np.asarray(alt_alleles, dtype=np.int8)
            offsets = tuple(int(o) for o in offsets)
            n, span_len = ref_spans.shape
            REF, ALT, SED = self._outputs(n, W.shape[1])
            basis_wire = basis.astype(self._basis_wire_dtype, copy=False)
            W_dev, bias_dev = self._model_tensors(W, bias)
            chunks = self._code_chunks(ref_spans, self._span_rows(len(offsets)))

        def jobs():
            for start, ref in chunks:
                stop = start + ref.shape[0]
                alt_a, basis_t = self._up(alt_alleles[start:stop]), self._up(basis_wire[:, start:stop])
                yield start, stop - start, self._fetch(*self._score_spans_chunk(
                    ref, alt_a, basis_t, W_dev, bias_dev, offsets, span_len, int(mutpos)))

        self._run_pipelined(jobs(), self._write_ref_sed(REF, ALT, SED))
        return REF, ALT, SED

    @_spanned
    @torch.inference_mode()
    def score_variant_spans_packed_rows(self, ref_spans_u, mutpos: int, alt_alleles_u, offsets, basis_rows,
                                        row_uidx, W, bias):
        """Fused serving over (variant, gene) rows that share variants: the
        conv/fc stack runs once per UNIQUE span; each row scores its own
        decay basis against a device-side gather of its variant's tracks.

        ``basis_rows``: (S, R, B); ``row_uidx``: (R,) nondecreasing index
        into the unique spans."""
        with profiling.span("runner.plan", rows=len(ref_spans_u)):
            ref_spans_u = np.asarray(ref_spans_u, dtype=np.int8)
            alt_alleles_u = np.asarray(alt_alleles_u, dtype=np.int8)
            row_uidx = np.asarray(row_uidx, dtype=np.int64)
            offsets = tuple(int(o) for o in offsets)
            n_u, span_len = ref_spans_u.shape
            rows = self._span_rows(len(offsets))
            REF, ALT, SED = self._outputs(row_uidx.shape[0], W.shape[1])
            basis_wire = basis_rows.astype(self._basis_wire_dtype, copy=False)
            r_bounds = self._row_chunk_bounds(row_uidx, n_u, rows)
            W_dev, bias_dev = self._model_tensors(W, bias)
            chunks = self._code_chunks(ref_spans_u, rows)

        def jobs():
            for (r0, r1), (start, ref) in zip(r_bounds, chunks):
                alt_a = self._up(alt_alleles_u[start : start + ref.shape[0]])
                idx, basis_t = self._up(row_uidx[r0:r1] - start), self._up(basis_wire[:, r0:r1])
                p_ref, p_alt = self._preds_from_ref(ref, alt_a, offsets, span_len, int(mutpos))
                yield r0, r1 - r0, self._fetch(*self._ref_sed(p_ref[idx], p_alt[idx], basis_t, W_dev, bias_dev))

        self._run_pipelined(jobs(), self._write_ref_sed(REF, ALT, SED))
        return REF, ALT, SED

    @_spanned
    @torch.inference_mode()
    def score_variant_span_pairs_rows(self, ref_spans_u, alt_spans_u, offsets, basis_rows, row_uidx, W, bias):
        """Pair serving (indels) over (variant, gene) rows sharing variants:
        both conv stacks run once per UNIQUE (ref, alt) span pair; each row
        scores its own decay basis against a device-side gather of its
        variant's tracks. Spans ship 2-bit packed, interleaved per pair, or
        4-bit for N-dense chunks."""
        with profiling.span("runner.plan", rows=len(ref_spans_u)):
            ref_spans_u = np.asarray(ref_spans_u, dtype=np.int8)
            alt_spans_u = np.asarray(alt_spans_u, dtype=np.int8)
            row_uidx = np.asarray(row_uidx, dtype=np.int64)
            offsets = tuple(int(o) for o in offsets)
            n_u, span_len = ref_spans_u.shape
            rows = self._pair_rows(len(offsets))
            REF, ALT, SED = self._outputs(row_uidx.shape[0], W.shape[1])
            basis_wire = basis_rows.astype(self._basis_wire_dtype, copy=False)
            r_bounds = self._row_chunk_bounds(row_uidx, n_u, rows)
            W_dev, bias_dev = self._model_tensors(W, bias)
            chunks = self._pair_chunks(ref_spans_u, alt_spans_u, rows)

        def jobs():
            for (r0, r1), (start, codes) in zip(r_bounds, chunks):
                idx, basis_t = self._up(row_uidx[r0:r1] - start), self._up(basis_wire[:, r0:r1])
                pair = codes.reshape(-1, 2, span_len)
                p_ref = self._pair_span_preds(pair[:, 0], offsets)
                p_alt = self._pair_span_preds(pair[:, 1], offsets)
                yield r0, r1 - r0, self._fetch(*self._ref_sed(p_ref[idx], p_alt[idx], basis_t, W_dev, bias_dev))

        self._run_pipelined(jobs(), self._write_ref_sed(REF, ALT, SED))
        return REF, ALT, SED
