"""Beluga serving engine on one device (port of the serving surface of
expecto_tpu/parallel/runner.py).

- the host ships compact base codes: 2 bits per base with N bases in a
  sparse (row, col) sideband, or 4 bits per base for N-dense batches; the
  device unpacks and one-hots them;
- the conv stack runs once per span and pool-2 phase (ops/spans.py), every
  conv on the hand-written CUDA kernel (ops/conv8.py);
- reverse complement is a flip of the one-hot tensor on the device, and
  forward/RC predictions are averaged there;
- the decay-basis projection and all stacked tissue models run on the device
  as one matmul, and only per-model scalars come back, as (REF, SED): SED =
  ALT - REF is taken in fp32 on the device before the cast to the fetch
  dtype, and the host rebuilds ALT = REF + SED in fp32.

Chunks run one after another (upload, compute, fetch); overlapping them with
CUDA streams and pinned host buffers is later work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.beluga import beluga_forward
from ..models.convert import params_from_jax
from ..ops.spans import (
    beluga_forward_spans,
    conv6_patch_ranges,
    conv6_phases,
    conv6_phases_patch,
    fc1_delta_from_phases,
    fc1_pre_from_phases,
    fc_head,
)


def onehot_from_codes(codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, L) int codes -> (N, L, 4); code 4 (N) one-hots to zeros."""
    return torch.eye(5, 4, dtype=dtype, device=codes.device)[codes.long()]


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
    """Pack four base codes per byte (2 bits/base); N bases (code 4) ride a
    sparse (rows, cols) sideband. Returns (packed (N, ceil(L/4)) uint8,
    rows, cols)."""
    n, l = codes.shape
    rows, cols = np.nonzero(codes == 4)
    c = np.where(codes == 4, 0, codes).astype(np.uint8)
    pad = (-l) % 4
    if pad:
        c = np.concatenate([c, np.zeros((n, pad), np.uint8)], axis=1)
    q = c.reshape(n, (l + pad) // 4, 4)
    packed = (q[:, :, 0] << 6) | (q[:, :, 1] << 4) | (q[:, :, 2] << 2) | q[:, :, 3]
    return packed, rows.astype(np.int32), cols.astype(np.int32)


def unpack_codes2(packed: torch.Tensor, length: int, n_rows: torch.Tensor, n_cols: torch.Tensor) -> torch.Tensor:
    """Device-side inverse of :func:`pack_codes2`. Sideband entries outside
    the (N, length) block are dropped, as the JAX scatter's ``mode="drop"``
    drops them (``index_put_`` would raise on them)."""
    b = packed
    c = torch.stack([(b >> 6) & 3, (b >> 4) & 3, (b >> 2) & 3, b & 3], dim=-1)
    c = c.reshape(b.shape[0], -1)[:, :length].to(torch.int8)
    keep = (n_rows >= 0) & (n_rows < c.shape[0]) & (n_cols >= 0) & (n_cols < length)
    c[n_rows[keep].long(), n_cols[keep].long()] = 4
    return c


def rc_onehot(x: torch.Tensor) -> torch.Tensor:
    """Reverse complement of a one-hot batch: flip positions and channels
    (valid under AGCT channel order)."""
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
    """

    #: per-chunk N-sideband budget of the 2-bit wire; denser batches ship
    #: 4 bits per base instead (N-padded contig-edge spans hit this)
    PACK2_SIDE_BUDGET = 16384

    def __init__(self, params, batch_size: int = 1024, *, device="cuda", compute_dtype=torch.float32,
                 out_dtype=np.float32):
        self.device = resolve_device(device)
        self.batch_size = max(int(batch_size), 1)
        self.compute_dtype = compute_dtype
        self.out_dtype = np.dtype(out_dtype)
        if compute_dtype == torch.float32:
            # parity mode: full fp32 products everywhere, never TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.set_float32_matmul_precision("highest")
        self.params = params_from_jax(params, device=self.device, dtype=compute_dtype)
        self._wire = _torch_dtype(self.out_dtype)

    # ---- host <-> device -------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @property
    def _basis_wire_dtype(self):
        # decay-basis weights are in (0, 1]; fp16 transfer loses nothing
        # beyond the production mode's bf16 precision
        return np.float16 if self.out_dtype == np.float16 else np.float32

    @staticmethod
    def _write_ref_sed(REF, ALT, SED, start: int, ref_t: torch.Tensor, sed_t: torch.Tensor) -> None:
        """Fetch one chunk of the (REF, SED) wire: SED is stored exactly as
        the device computed it and ALT is rebuilt as REF + SED in fp32."""
        ref = ref_t.cpu().numpy().astype(np.float32)
        sed = sed_t.cpu().numpy().astype(np.float32)
        stop = start + ref.shape[0]
        REF[start:stop] = ref
        SED[start:stop] = sed
        ALT[start:stop] = ref + sed

    def _span_rows(self, n_offsets: int) -> int:
        return max(self.batch_size // n_offsets, 1)

    def _pair_rows(self, n_offsets: int) -> int:
        """Pairs per call for the two-span paths: each pair is two spans."""
        return max(self._span_rows(n_offsets) // 2, 1)

    def _pack2_plan(self, span_codes: np.ndarray, rows: int):
        """2-bit packing plan for chunks of ``rows`` spans, or None when a
        chunk is too N-dense for the sparse sideband."""
        n = span_codes.shape[0]
        packed, n_rows, n_cols = pack_codes2(span_codes)
        starts = list(range(0, n, rows))
        bounds = [
            (int(np.searchsorted(n_rows, s)), int(np.searchsorted(n_rows, min(s + rows, n)))) for s in starts
        ]
        if max((b - a for a, b in bounds), default=0) > self.PACK2_SIDE_BUDGET:
            return None
        return packed, n_rows, n_cols, starts, bounds

    def _pack2_chunks(self, plan, rows: int, n: int):
        """Yield (start, real, packed, n_rows, n_cols) device tensors per chunk."""
        packed, n_rows, n_cols, starts, bounds = plan
        for start, (i0, i1) in zip(starts, bounds):
            end = min(start + rows, n)
            yield (start, end - start, self._dev(packed[start:end]),
                   self._dev(n_rows[i0:i1] - start), self._dev(n_cols[i0:i1]))

    @staticmethod
    def _row_chunk_plan(row_uidx: np.ndarray, n_u: int, rows: int):
        """Chunks of ``rows`` unique variants for (variant, gene) rows whose
        nondecreasing ``row_uidx`` maps them onto unique variants:
        (chunk starts, per-chunk row bounds)."""
        starts = list(range(0, n_u, rows))
        r_bounds = [
            (int(np.searchsorted(row_uidx, s)), int(np.searchsorted(row_uidx, min(s + rows, n_u)))) for s in starts
        ]
        return starts, r_bounds

    def _model_tensors(self, W: np.ndarray, bias: np.ndarray):
        return (torch.as_tensor(W, dtype=torch.float32, device=self.device),
                torch.as_tensor(bias, dtype=torch.float32, device=self.device))

    @staticmethod
    def _outputs(n: int, k: int):
        return tuple(np.empty((n, k), dtype=np.float32) for _ in range(3))

    # ---- device functions --------------------------------------------------

    def _forward(self, codes: torch.Tensor, with_rc: bool, out: torch.dtype) -> torch.Tensor:
        x = onehot_from_codes(codes, dtype=self.compute_dtype)
        y = beluga_forward(self.params, x).float()
        if with_rc:
            y = (y + beluga_forward(self.params, rc_onehot(x)).float()) * 0.5
        return y.to(out)

    def _pair_span_preds(self, spans: torch.Tensor, offsets) -> torch.Tensor:
        """fwd/RC-averaged (N, S, M) fp32 track predictions of a span batch."""
        x = onehot_from_codes(spans, dtype=self.compute_dtype)
        y = beluga_forward_spans(self.params, x, offsets).float()
        extra = spans.shape[1] - 2000
        rc_off = tuple(extra - o for o in offsets)
        y_rc = beluga_forward_spans(self.params, rc_onehot(x), rc_off).float()
        return (y + y_rc) * 0.5

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

        x_ref = onehot_from_codes(ref, dtype=self.compute_dtype)
        x_alt = onehot_from_codes(alt, dtype=self.compute_dtype)
        extra = span_len - 2000
        rc_offsets = tuple(extra - o for o in offsets)
        phases_f = {(o // 4) % 4 for o in offsets}
        phases_r = {(o // 4) % 4 for o in rc_offsets}
        mut_rc = span_len - mutpos - a_len

        ph_ref_f = conv6_phases(self.params, x_ref, phases_f)
        ph_ref_r = conv6_phases(self.params, rc_onehot(x_ref), phases_r)
        ph_alt_f = conv6_phases_patch(self.params, ph_ref_f, x_alt, mutpos, a_len, phases_f)
        ph_alt_r = conv6_phases_patch(self.params, ph_ref_r, rc_onehot(x_alt), mut_rc, a_len, phases_r)

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

    def _ref_sed(self, p_ref, p_alt, basis, W, bias):
        """(REF, SED) at the wire dtype from (R, S, M) predictions, an
        (S, R, B) decay basis and stacked (B*M, K) models: per-row decay
        features, every model in one matmul, SED differenced in fp32."""

        def feats(p):
            return torch.einsum("srb,rsm->rbm", basis.float(), p).reshape(p.shape[0], -1)

        REF = feats(p_ref) @ W + bias
        ALT = feats(p_alt) @ W + bias
        return REF.to(self._wire), (ALT - REF).to(self._wire)

    # ---- public API ----------------------------------------------------------

    @torch.inference_mode()
    def predict_codes(self, codes: np.ndarray, *, average_rc: bool = False, out_dtype=None) -> np.ndarray:
        """Run Beluga over int8 base codes (N, 2000) -> (N, 2002).

        ``average_rc=True`` averages forward and reverse-complement
        predictions on the device. ``out_dtype`` overrides the runner's
        fetch dtype for this call."""
        codes = np.asarray(codes, dtype=np.int8)
        fetch = self.out_dtype if out_dtype is None else np.dtype(out_dtype)
        out = np.empty((codes.shape[0], 2002), dtype=fetch)
        for start in range(0, codes.shape[0], self.batch_size):
            chunk = self._dev(codes[start : start + self.batch_size])
            y = self._forward(chunk, average_rc, _torch_dtype(fetch))
            out[start : start + chunk.shape[0]] = y.cpu().numpy()
        return out

    @torch.inference_mode()
    def score_variant_spans(self, ref_spans, alt_spans, offsets, basis, W, bias):
        """Fused SED serving of explicit (ref, alt) span pairs: (N, span_len)
        spans + (S, N, B) decay basis + stacked model weights (F, K) ->
        (REF, ALT, SED), each (N, K). Both spans ship 2-bit packed,
        interleaved per variant, or unpacked for N-dense batches."""
        ref_spans = np.asarray(ref_spans, dtype=np.int8)
        alt_spans = np.asarray(alt_spans, dtype=np.int8)
        offsets = tuple(int(o) for o in offsets)
        n, span_len = ref_spans.shape
        rows = self._pair_rows(len(offsets))
        W_dev, bias_dev = self._model_tensors(W, bias)
        REF, ALT, SED = self._outputs(n, W.shape[1])
        basis_wire = basis.astype(self._basis_wire_dtype, copy=False)

        inter = np.empty((2 * n, span_len), dtype=np.int8)
        inter[0::2] = ref_spans
        inter[1::2] = alt_spans
        plan = self._pack2_plan(inter, 2 * rows)
        if plan is not None:
            chunks = (
                (s2 // 2, unpack_codes2(p, span_len, rl, cl).reshape(-1, 2, span_len))
                for s2, _r2, p, rl, cl in self._pack2_chunks(plan, 2 * rows, 2 * n)
            )
        else:
            chunks = (
                (s, torch.stack([self._dev(ref_spans[s : s + rows]), self._dev(alt_spans[s : s + rows])], dim=1))
                for s in range(0, n, rows)
            )
        for start, pair in chunks:
            p_ref = self._pair_span_preds(pair[:, 0], offsets)
            p_alt = self._pair_span_preds(pair[:, 1], offsets)
            basis_t = self._dev(basis_wire[:, start : start + pair.shape[0]])
            self._write_ref_sed(REF, ALT, SED, start, *self._ref_sed(p_ref, p_alt, basis_t, W_dev, bias_dev))
        return REF, ALT, SED

    @torch.inference_mode()
    def score_variant_spans_packed(self, ref_spans, mutpos: int, alt_alleles, offsets, basis, W, bias):
        """Fused SED serving from one span per variant: (N, span_len) ref
        spans + (N, A) alt-allele codes spliced on the device at ``mutpos``
        (-1 keeps the reference base). Spans ship 2-bit packed, or 4-bit for
        N-dense batches."""
        ref_spans = np.asarray(ref_spans, dtype=np.int8)
        alt_alleles = np.asarray(alt_alleles, dtype=np.int8)
        offsets = tuple(int(o) for o in offsets)
        n, span_len = ref_spans.shape
        rows = self._span_rows(len(offsets))
        W_dev, bias_dev = self._model_tensors(W, bias)
        REF, ALT, SED = self._outputs(n, W.shape[1])
        basis_wire = basis.astype(self._basis_wire_dtype, copy=False)

        plan = self._pack2_plan(ref_spans, rows)
        if plan is not None:
            chunks = (
                (s, unpack_codes2(p, span_len, rl, cl)) for s, _r, p, rl, cl in self._pack2_chunks(plan, rows, n)
            )
        else:
            packed = pack_codes(ref_spans)
            chunks = ((s, unpack_codes(self._dev(packed[s : s + rows]), span_len)) for s in range(0, n, rows))
        for start, ref in chunks:
            stop = start + ref.shape[0]
            p_ref, p_alt = self._preds_from_ref(ref, self._dev(alt_alleles[start:stop]), offsets, span_len, int(mutpos))
            basis_t = self._dev(basis_wire[:, start:stop])
            self._write_ref_sed(REF, ALT, SED, start, *self._ref_sed(p_ref, p_alt, basis_t, W_dev, bias_dev))
        return REF, ALT, SED

    @torch.inference_mode()
    def score_variant_spans_packed_rows(self, ref_spans_u, mutpos: int, alt_alleles_u, offsets, basis_rows,
                                        row_uidx, W, bias):
        """Fused serving over (variant, gene) rows that share variants: the
        conv/fc stack runs once per UNIQUE span; each row scores its own
        decay basis against a device-side gather of its variant's tracks.

        ``basis_rows``: (S, R, B); ``row_uidx``: (R,) nondecreasing index
        into the unique spans."""
        ref_spans_u = np.asarray(ref_spans_u, dtype=np.int8)
        alt_alleles_u = np.asarray(alt_alleles_u, dtype=np.int8)
        row_uidx = np.asarray(row_uidx, dtype=np.int64)
        offsets = tuple(int(o) for o in offsets)
        n_u, span_len = ref_spans_u.shape
        rows = self._span_rows(len(offsets))
        plan = self._pack2_plan(ref_spans_u, rows)
        if plan is None:
            # N-dense: expand and take the per-row path
            return self.score_variant_spans_packed(
                ref_spans_u[row_uidx], mutpos, alt_alleles_u[row_uidx], offsets, basis_rows, W, bias
            )
        W_dev, bias_dev = self._model_tensors(W, bias)
        REF, ALT, SED = self._outputs(row_uidx.shape[0], W.shape[1])
        basis_wire = basis_rows.astype(self._basis_wire_dtype, copy=False)
        _starts, r_bounds = self._row_chunk_plan(row_uidx, n_u, rows)
        for (r0, r1), (start, real_u, p, rl, cl) in zip(r_bounds, self._pack2_chunks(plan, rows, n_u)):
            ref = unpack_codes2(p, span_len, rl, cl)
            alt_a = self._dev(alt_alleles_u[start : start + real_u])
            p_ref, p_alt = self._preds_from_ref(ref, alt_a, offsets, span_len, int(mutpos))
            idx = self._dev(row_uidx[r0:r1] - start)
            basis_t = self._dev(basis_wire[:, r0:r1])
            self._write_ref_sed(REF, ALT, SED, r0, *self._ref_sed(p_ref[idx], p_alt[idx], basis_t, W_dev, bias_dev))
        return REF, ALT, SED

    @torch.inference_mode()
    def score_variant_span_pairs_rows(self, ref_spans_u, alt_spans_u, offsets, basis_rows, row_uidx, W, bias):
        """Pair serving (indels) over (variant, gene) rows sharing variants:
        both conv stacks run once per UNIQUE (ref, alt) span pair; each row
        scores its own decay basis against a device-side gather of its
        variant's tracks. Spans ship 2-bit packed, interleaved per pair."""
        ref_spans_u = np.asarray(ref_spans_u, dtype=np.int8)
        alt_spans_u = np.asarray(alt_spans_u, dtype=np.int8)
        row_uidx = np.asarray(row_uidx, dtype=np.int64)
        offsets = tuple(int(o) for o in offsets)
        n_u, span_len = ref_spans_u.shape
        rows = self._pair_rows(len(offsets))

        inter = np.empty((2 * n_u, span_len), dtype=np.int8)
        inter[0::2] = ref_spans_u
        inter[1::2] = alt_spans_u
        plan = self._pack2_plan(inter, 2 * rows)
        if plan is None:
            # N-dense: expand and take the per-row pair path
            return self.score_variant_spans(
                ref_spans_u[row_uidx], alt_spans_u[row_uidx], offsets, basis_rows, W, bias
            )
        W_dev, bias_dev = self._model_tensors(W, bias)
        REF, ALT, SED = self._outputs(row_uidx.shape[0], W.shape[1])
        basis_wire = basis_rows.astype(self._basis_wire_dtype, copy=False)
        starts, r_bounds = self._row_chunk_plan(row_uidx, n_u, rows)
        for start, (r0, r1), (_s2, _r2, p, rl, cl) in zip(
            starts, r_bounds, self._pack2_chunks(plan, 2 * rows, 2 * n_u)
        ):
            pair = unpack_codes2(p, span_len, rl, cl).reshape(-1, 2, span_len)
            p_ref = self._pair_span_preds(pair[:, 0], offsets)
            p_alt = self._pair_span_preds(pair[:, 1], offsets)
            idx = self._dev(row_uidx[r0:r1] - start)
            basis_t = self._dev(basis_wire[:, r0:r1])
            self._write_ref_sed(REF, ALT, SED, r0, *self._ref_sed(p_ref[idx], p_alt[idx], basis_t, W_dev, bias_dev))
        return REF, ALT, SED
