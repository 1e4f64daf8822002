"""``genes``: ``expecto_tpu_torch.pipeline.features.compute_gene_features``
(the ``expecto-compute-features`` CLI's call) on new genes each call.

The check compares a sample of the window's feature vectors:
``feature_gap`` = max |F - F_ref| over the sample's largest |F_ref|."""

from __future__ import annotations

import numpy as np

from .. import flops, inputs
from ..reference import expecto as ref_expecto
from . import BelugaFlow, gap


class GeneFlow(BelugaFlow):
    @property
    def units_per_call(self):
        return int(self.traffic["genes_per_call"])

    def work_per_call(self):
        return flops.gene_call_work(self.cfg, self.traffic)

    def setup(self) -> None:
        from expecto_tpu_torch.pipeline.features import compute_gene_features

        self._features = compute_gene_features
        self.genome_and_fasta()
        self.mark("genome")
        self.build_runner()
        self.warm(self._features, self.make_input(10**6)[1], self.fasta, self.runner)

    def make_input(self, i: int):
        from expecto_tpu_torch.pipeline.features import GeneRecord

        genes = inputs.make_genes(self.seed, i, self.genome, self.traffic)
        return genes, [GeneRecord(gene_id=g, chrom=c, tss=int(t), strand=int(s))
                       for g, c, t, s in zip(genes.gene, genes.chrom, genes.tss, genes.strand)]

    def call(self, i: int) -> None:
        feats = self._features(self.input(i)[1], self.fasta, self.runner)
        g = inputs.rng(self.seed, "sample", i)
        rows = np.sort(g.choice(len(feats), int(self.traffic["sample_per_call"]), replace=False))
        self.kept.append((i, rows, feats[rows].astype(np.float64)))

    def program_functions(self):
        import expecto_tpu_torch.pipeline.features as features

        return [(features, ("gene_span_and_offsets", "_offset_groups"))]

    def check(self, control=None):
        sample = [(i, r, row) for i, rows, F in self.kept for r, row in zip(rows, F)]
        limit = int(self.traffic["sample_max"])
        if len(sample) > limit:
            pick = inputs.rng(self.seed, "sample_after").choice(len(sample), limit, replace=False)
            sample = [sample[j] for j in sorted(pick)]
        gl = [(self.pool[i][0], r) for i, r, _ in sample]
        args = ([g.chrom[r] for g, r in gl], [int(g.tss[r]) for g, r in gl], [int(g.strand[r]) for g, r in gl])
        ref = ref_expecto.gene_features(self.reference_net(None), self.genome, *args)
        if control is None:
            prog = np.stack([row for *_x, row in sample])
        else:
            prog = ref_expecto.gene_features(self.reference_net(control), self.genome, *args,
                                             head="tf32" if control == "tf32" else "fp32")
        self._row_gaps = {"feature_gap": gap(prog, ref, float(np.abs(ref).max())).max(axis=1)}
        return {k: float(v.max()) for k, v in self._row_gaps.items()}

    def failed_units(self, limits):
        return int((~(self._row_gaps["feature_gap"] <= limits["feature_gap"])).sum())


FLOW = GeneFlow
