"""``score``: ``expecto_tpu_torch.pipeline.sed.score_sed_serving`` (the
``expecto-score`` CLI without its CSV) on a ``BelugaRunner`` built as
``cli/score.py`` builds it; each call a new VCF chunk and its closest-gene
table, the tissue models parsed from their files each call.

The check compares REF and SED of every model on a sample of the window's
rows: ``ref_gap`` scaled by the largest |REF - bias - base_score| of the
sample, ``sed_gap_snv`` and ``sed_gap_indel`` each over its own kind's rows
and scaled by their largest |SED|, so a fault in the SNV path is not
measured against the larger SEDs of indels."""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import flops, inputs
from ..reference import expecto as ref_expecto
from . import BelugaFlow, gap


class ScoreFlow(BelugaFlow):
    @property
    def units_per_call(self):
        return int(self.traffic["variants_per_call"])

    def work_per_call(self):
        return flops.score_call_work(self.cfg, self.traffic)

    def _frames(self, chunk: inputs.VcfChunk):
        import pandas as pd

        vcf = pd.DataFrame({0: chunk.chrom, 1: chunk.pos, 2: ".", 3: chunk.ref, 4: chunk.alt})
        bare = np.array([c[3:] for c in chunk.chrom], dtype=object)
        gene = pd.DataFrame({0: bare, 1: chunk.pos - 1, 2: chunk.pos, 3: chunk.ref, 4: chunk.alt, 5: bare,
                             6: chunk.tss - 1, 7: chunk.tss, 8: chunk.strand, 9: chunk.gene,
                             10: chunk.tss - chunk.pos})
        return vcf, gene

    def setup(self) -> None:
        from expecto_tpu_torch.pipeline.sed import score_sed_serving

        self._score = score_sed_serving
        self.genome_and_fasta()
        self.annotation = inputs.make_annotation(self.genome, int(self.traffic["tss_spacing"]))
        n_feat = 10 * int(self.cfg["tracks"])
        self.models = inputs.make_models(self.seed, n_feat, int(self.cfg["tissue_models"]),
                                         float(self.cfg["base_score"]), self.device)
        self.model_paths = inputs.write_models(self.models, os.path.join(self.workdir, "models"))
        self.names = [os.path.basename(p) for p in self.model_paths]
        self.mark("genome and models")
        self.build_runner()
        self.warm(self._run, *self._frames(self.make_input(10**6)[0]))

    def make_input(self, i: int):
        chunk = inputs.make_vcf(self.seed, i, self.genome, self.annotation, self.traffic)
        return chunk, self._frames(chunk)

    def _run(self, vcf, gene):
        return self._score(vcf, gene, self.fasta, self.runner, self.model_paths, maxshift=int(self.cfg["maxshift"]),
                           output_csv=None)

    def _pick(self, chunk: inputs.VcfChunk, i: int) -> np.ndarray:
        """Call ``i``'s sampled rows: ``sample_snv`` SNVs and
        ``sample_indel`` indels, with the chunk's longest insertion and
        longest deletion among them."""
        g = inputs.rng(self.seed, "sample", i)
        dl = np.array([len(a) - len(r) for r, a in zip(chunk.ref, chunk.alt)])
        snv, ind = np.flatnonzero(dl == 0), np.flatnonzero(dl != 0)
        longest = [int(np.flatnonzero(dl == dl.max())[0]), int(np.flatnonzero(dl == dl.min())[0])] if len(ind) else []
        rest = np.setdiff1d(ind, longest)
        k_ind = max(int(self.traffic["sample_indel"]) - len(longest), 0)
        rows = np.concatenate([g.choice(snv, min(int(self.traffic["sample_snv"]), len(snv)), replace=False),
                               longest, g.choice(rest, min(k_ind, len(rest)), replace=False)]).astype(np.int64)
        return np.sort(rows)

    def call(self, i: int) -> None:
        chunk, frames = self.input(i)
        df = self._run(*frames)
        rows = self._pick(chunk, i)
        part = df.iloc[rows]
        self.kept.append((i, rows, part[[f"REF_{n}" for n in self.names]].to_numpy(np.float64),
                          part[self.names].to_numpy(np.float64)))

    def program_functions(self):
        import expecto_tpu_torch.pipeline.sed as sed

        return [(sed, ("_stacked_models", "align_variants_with_genes", "_span_eligible", "_gather_spans",
                       "assemble_variant_spans", "_factorize_variant_rows", "variant_basis"))]

    def _sample(self):
        """The rows the check compares, (call, row, place in the call's
        kept rows): all kept rows, or ``sample_max`` of them drawn from the
        seed, an eighth of them indels of the largest length."""
        rows = [(i, r, k) for i, rs, *_ in self.kept for k, r in enumerate(rs)]
        limit = int(self.traffic["sample_max"])
        if len(rows) <= limit:
            return rows
        g = inputs.rng(self.seed, "sample_after")
        longest = int(self.traffic["indel_max_len"])
        is_long = [abs(len(self.pool[i][0].alt[r]) - len(self.pool[i][0].ref[r])) == longest for i, r, _ in rows]
        forced = g.permutation(np.flatnonzero(is_long))[: limit // 8]
        rest = np.setdiff1d(np.arange(len(rows)), forced)
        pick = np.concatenate([forced, g.choice(rest, limit - len(forced), replace=False)])
        return [rows[j] for j in sorted(pick)]

    def check(self, control=None):
        by_call = {i: (R, S) for i, _rs, R, S in self.kept}
        sample = self._sample()
        rows = [(self.pool[i][0], r) for i, r, _ in sample]
        args = ([c.chrom[r] for c, r in rows], [int(c.pos[r]) for c, r in rows], [c.ref[r] for c, r in rows],
                [c.alt[r] for c, r in rows], [int(c.tss[r]) for c, r in rows], [c.strand[r] for c, r in rows])
        W = torch.from_numpy(self.models.W).to(self.device)
        b = torch.from_numpy(self.models.bias).to(self.device)
        maxshift = int(self.cfg["maxshift"])
        R, _A, S = ref_expecto.score_variants(self.reference_net(None), self.genome, *args, W, b,
                                              self.models.base_score, maxshift=maxshift)
        if control is None:
            pR = np.stack([by_call[i][0][k] for i, _r, k in sample])
            pS = np.stack([by_call[i][1][k] for i, _r, k in sample])
        else:
            # the control in the program's place, against the reference
            pR, _pA, pS = ref_expecto.score_variants(self.reference_net(control), self.genome, *args, W, b,
                                                     self.models.base_score, maxshift=maxshift,
                                                     head={"tf32": "tf32"}.get(control, "fp32"))
        offset = self.models.bias.astype(np.float64) + self.models.base_score
        snv = np.array([len(r) == len(a) for r, a in zip(args[2], args[3])])
        self._row_gaps = {"ref_gap": gap(pR, R, float(np.abs(R - offset).max())).max(axis=1)}
        for kind, on in (("snv", snv), ("indel", ~snv)):
            rows_gap = np.zeros(len(snv))
            if on.any():
                rows_gap[on] = gap(pS[on], S[on], float(np.abs(S[on]).max())).max(axis=1)
            self._row_gaps[f"sed_gap_{kind}"] = rows_gap
        return {k: float(v.max()) for k, v in self._row_gaps.items()}

    def failed_units(self, limits):
        rows = np.zeros(len(self._row_gaps["ref_gap"]), bool)
        for k, v in self._row_gaps.items():
            rows |= ~(v <= limits[k])
        return int(rows.sum())


FLOW = ScoreFlow
