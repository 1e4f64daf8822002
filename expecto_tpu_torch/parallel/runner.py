"""Beluga serving engine on one device (port of the serving surface of
expecto_tpu/parallel/runner.py).

- the host ships compact base codes: 2 bits per base with N bases in a
  sparse (row, col) sideband, or 4 bits per base for N-dense batches; the
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

Chunks run one after another (upload, compute, fetch); overlapping them with
CUDA streams and pinned host buffers is later work.
"""

from __future__ import annotations

import numpy as np
import torch

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

    def _code_chunks(self, span_codes: np.ndarray, rows: int):
        """Yield (start, (real, L) int8 device codes) per chunk of ``rows``
        spans: 2-bit packed with the N sideband, or 4-bit for N-dense
        batches."""
        n, span_len = span_codes.shape
        plan = self._pack2_plan(span_codes, rows)
        if plan is not None:
            for start, _real, p, rl, cl in self._pack2_chunks(plan, rows, n):
                yield start, unpack_codes2(p, span_len, rl, cl)
        else:
            packed = pack_codes(span_codes)
            for start in range(0, n, rows):
                yield start, unpack_codes(self._dev(packed[start : start + rows]), span_len)

    def _pair_chunks(self, ref_spans: np.ndarray, alt_spans: np.ndarray, rows: int):
        """Yield (start, (2 * real, L) device codes interleaved per pair,
        [r0, a0, r1, a1, ...]) per chunk of ``rows`` pairs: both alleles run
        through the conv stack as one batch."""
        n, span_len = ref_spans.shape
        inter = np.empty((2 * n, span_len), dtype=np.int8)
        inter[0::2] = ref_spans
        inter[1::2] = alt_spans
        for start2, codes in self._code_chunks(inter, 2 * rows):
            yield start2 // 2, codes

    def _pair_diff_chunks(self, ref_spans, alt_spans, offsets, with_ref: bool):
        """Yield (start, :meth:`_pair_diff_wire` on the host) per chunk of
        (ref, alt) span pairs."""
        offsets = tuple(int(o) for o in offsets)
        ref_spans = np.asarray(ref_spans, dtype=np.int8)
        alt_spans = np.asarray(alt_spans, dtype=np.int8)
        for start, codes in self._pair_chunks(ref_spans, alt_spans, self._pair_rows(len(offsets))):
            yield start, self._pair_diff_wire(codes, offsets, with_ref)

    def _pair_diff_wire(self, codes: torch.Tensor, offsets, with_ref: bool) -> np.ndarray:
        """h5-contract wire of one interleaved pair chunk: ``(ref, diff)``
        stacked as (P, 2, 2[fwd|rc], S, M), or ``diff`` alone as
        (P, 2[fwd|rc], S, M), at the fetch dtype. ``diff = alt - ref`` is
        taken in fp32 on the device before the cast, so an fp16 wire keeps
        diff's relative precision."""
        p = self._span_preds_fwd_rc(codes, offsets)
        ref, diff = p[0::2], p[1::2] - p[0::2]
        y = torch.stack([ref, diff], dim=1) if with_ref else diff
        return y.to(self._wire).cpu().numpy()

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
    def predict_span_codes(self, span_codes: np.ndarray, offsets, *, rc_mode: str = "none") -> np.ndarray:
        """Span-amortized forward: (N, span_len) int8 codes -> per-window
        predictions for windows span[o : o+2000] at each offset, at the
        fetch dtype.

        rc_mode: 'none' -> (N, O, 2002); 'average' -> fwd/RC averaged
        (N, O, 2002); 'concat' -> (N, 2, O, 2002) with fwd at [:, 0], RC at
        [:, 1]."""
        if rc_mode not in ("none", "average", "concat"):
            raise ValueError(rc_mode)
        span_codes = np.asarray(span_codes, dtype=np.int8)
        offsets = tuple(int(o) for o in offsets)
        n = span_codes.shape[0]
        shape = (n, 2, len(offsets), 2002) if rc_mode == "concat" else (n, len(offsets), 2002)
        out = np.empty(shape, dtype=self.out_dtype)
        for start, codes in self._code_chunks(span_codes, self._span_rows(len(offsets))):
            if rc_mode == "none":
                y = beluga_forward_spans(self.params, codes, offsets).float()
            else:
                y = self._span_preds_fwd_rc(codes, offsets)
                if rc_mode == "average":
                    y = (y[:, 0] + y[:, 1]) * 0.5
            out[start : start + codes.shape[0]] = y.to(self._wire).cpu().numpy()
        return out

    def _project(self, preds: torch.Tensor, pos_weights: torch.Tensor) -> np.ndarray:
        """(G, S, M) fp32 predictions against (B, S) decay weights -> (G,
        B*M) features, contracted in fp32 on the device and fetched at the
        wire dtype (an fp16 wire rounds at about 5e-4 relative), stored fp32."""
        feats = torch.einsum("bs,nsm->nbm", pos_weights, preds).reshape(preds.shape[0], -1)
        return feats.to(self._wire).cpu().numpy().astype(np.float32)

    @torch.inference_mode()
    def predict_spans_project(self, span_codes: np.ndarray, offsets, pos_weights: np.ndarray) -> np.ndarray:
        """Gene path on the device: (N, span_len) int8 span codes -> shared
        conv stack over each span's windows at ``offsets``, forward and
        reverse complement averaged in fp32, the (B, n_offsets) decay
        weights applied -> (N, B*2002) float32 features. Spans ship 2-bit
        packed, or 4-bit for N-dense chunks."""
        span_codes = np.asarray(span_codes, dtype=np.int8)
        offsets = tuple(int(o) for o in offsets)
        pw = torch.as_tensor(np.asarray(pos_weights, dtype=np.float32), device=self.device)
        out = np.empty((span_codes.shape[0], pw.shape[0] * 2002), dtype=np.float32)
        for start, codes in self._code_chunks(span_codes, self._span_rows(len(offsets))):
            out[start : start + codes.shape[0]] = self._project(self._pair_span_preds(codes, offsets), pw)
        return out

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
        backbone_span = np.asarray(backbone_span, dtype=np.int8)
        sample_spans = np.asarray(sample_spans, dtype=np.int8)
        offsets = tuple(int(o) for o in offsets)
        starts_f, starts_r = np.asarray(starts_f, dtype=np.int64), np.asarray(starts_r, dtype=np.int64)
        # K buckets in steps of 8, as the JAX runner compiles one program per
        # bucket: an inactive slot still convolves real bases
        k_pad = -(-max(starts_f.shape[1], starts_r.shape[1], 1) // 8) * 8
        starts_f, starts_r = (np.pad(s, ((0, 0), (0, k_pad - s.shape[1]), (0, 0))) for s in (starts_f, starts_r))
        pw = torch.as_tensor(np.asarray(pos_weights, dtype=np.float32), device=self.device)
        rc_offsets = tuple(sample_spans.shape[1] - 2000 - o for o in offsets)
        phases_f = {(o // 4) % 4 for o in offsets}
        phases_r = {(o // 4) % 4 for o in rc_offsets}
        ph_f, ph_r = self._backbone_phases(self._dev(backbone_span[None]), offsets)
        out = np.empty((sample_spans.shape[0], pw.shape[0] * 2002), dtype=np.float32)
        for start, codes in self._code_chunks(sample_spans, self._span_rows(len(offsets))):
            stop = start + codes.shape[0]
            pf = conv6_phases_patch_sites(self.params, ph_f, codes, self._dev(starts_f[start:stop, :, 0]), phases_f)
            pr = conv6_phases_patch_sites(self.params, ph_r, rc_codes(codes), self._dev(starts_r[start:stop, :, 0]),
                                          phases_r)
            y = fc_from_phases(self.params, pf, offsets).float()
            y_rc = fc_from_phases(self.params, pr, rc_offsets).float()
            out[start:stop] = self._project((y + y_rc) * 0.5, pw)
        return out

    @torch.inference_mode()
    def predict_and_project(self, codes: np.ndarray, pos_weights: np.ndarray, n_shifts: int) -> np.ndarray:
        """Gene path per window: (G*S, 2000) window codes, S consecutive rows
        a gene, + (B, S) decay weights -> (G, B*2002) float32 features, fwd/RC
        averaged and projected on the device (the per-window counterpart of
        :meth:`predict_spans_project`)."""
        codes = np.asarray(codes, dtype=np.int8)
        if codes.shape[0] % n_shifts != 0:
            raise ValueError("codes rows must be a multiple of n_shifts")
        pw = torch.as_tensor(np.asarray(pos_weights, dtype=np.float32), device=self.device)
        genes_per_batch = max(self.batch_size // n_shifts, 1)
        n_genes = codes.shape[0] // n_shifts
        out = np.empty((n_genes, pw.shape[0] * 2002), dtype=np.float32)
        for g0 in range(0, n_genes, genes_per_batch):
            g1 = min(g0 + genes_per_batch, n_genes)
            y = self._forward(self._dev(codes[g0 * n_shifts : g1 * n_shifts]), True, torch.float32)
            out[g0:g1] = self._project(y.reshape(g1 - g0, n_shifts, -1), pw)
        return out

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
        the method returns None. The sink is called synchronously, in chunk
        order, from the calling thread, while the card waits."""
        n = len(ref_spans)
        if sink is None:
            REF, ALT, DIFF = (np.empty((2 * n, len(offsets), 2002), dtype=np.float32) for _ in range(3))
        for start, y in self._pair_diff_chunks(ref_spans, alt_spans, offsets, with_ref=True):
            r = y.shape[0]  # y: (r, 2[ref|diff], 2[fwd|rc], S, M) at the wire dtype
            if sink is not None:
                ref = y[:, 0].astype(np.float32)
                diff = y[:, 1].astype(np.float32)
                sink(start, r, ref, ref + diff, diff)
                continue
            for orient, s0 in ((0, start), (1, n + start)):  # fwd rows, then rc rows
                ref, diff = REF[s0 : s0 + r], DIFF[s0 : s0 + r]
                ref[...] = y[:, 0, orient]  # an fp16 wire converts in place
                diff[...] = y[:, 1, orient]
                np.add(ref, diff, out=ALT[s0 : s0 + r])
        return None if sink is not None else (REF, ALT, DIFF)

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
        if sink is None:
            DIFF = np.empty((2 * n, len(offsets), 2002), dtype=np.float32)
        for start, y in self._pair_diff_chunks(ref_spans, alt_spans, offsets, with_ref=False):
            r = y.shape[0]  # y: (r, 2[fwd|rc], S, M) at the wire dtype
            if sink is not None:
                sink(start, r, y.astype(np.float32))
                continue
            DIFF[start : start + r] = y[:, 0]
            DIFF[n + start : n + start + r] = y[:, 1]
        return None if sink is not None else DIFF

    @torch.inference_mode()
    def score_variant_spans(self, ref_spans, alt_spans, offsets, basis, W, bias):
        """Fused SED serving of explicit (ref, alt) span pairs: (N, span_len)
        spans + (S, N, B) decay basis + stacked model weights (F, K) ->
        (REF, ALT, SED), each (N, K). Both spans ship 2-bit packed,
        interleaved per variant, or 4-bit for N-dense batches."""
        ref_spans = np.asarray(ref_spans, dtype=np.int8)
        alt_spans = np.asarray(alt_spans, dtype=np.int8)
        offsets = tuple(int(o) for o in offsets)
        n, span_len = ref_spans.shape
        W_dev, bias_dev = self._model_tensors(W, bias)
        REF, ALT, SED = self._outputs(n, W.shape[1])
        basis_wire = basis.astype(self._basis_wire_dtype, copy=False)
        for start, codes in self._pair_chunks(ref_spans, alt_spans, self._pair_rows(len(offsets))):
            pair = codes.reshape(-1, 2, span_len)
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
        W_dev, bias_dev = self._model_tensors(W, bias)
        REF, ALT, SED = self._outputs(n, W.shape[1])
        basis_wire = basis.astype(self._basis_wire_dtype, copy=False)
        for start, ref in self._code_chunks(ref_spans, self._span_rows(len(offsets))):
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
