"""``train``: ``expecto_tpu_torch.models.gblinear.train_gblinear_multi_sharded``
(``pipeline/train.py``'s vectorized multi-tissue sweep in one process), one
whole sweep a call, X handed over as a host array and uploaded by the call.

Each call first flips the sign of ``flip_rows`` rows of X, drawn from the
seed and the call's index, in place: every call's X differs from the last
one's, so a device copy kept from an earlier call is stale and the check
sees it. The check rebuilds X and Y from the seed, replays the flips of
every call up to the last, and trains the reference on that.

``weight_gap``: the worst model's max |w - w_ref| over the larger of its max
|w_ref| and the median model's; ``bias_gap`` the same of the biases."""

from __future__ import annotations

import functools
import statistics

import numpy as np
import torch

from .. import flops, inputs
from ..reference import gblinear as ref_gblinear
from . import Flow, gap


class TrainFlow(Flow):
    @property
    def units_per_call(self):
        return int(self.cfg["gblinear"]["num_round"])

    def work_per_call(self):
        return flops.train_call_work(self.cfg, self.traffic)

    def _hp(self):
        from expecto_tpu_torch.models.gblinear import GBLinearParams

        g = self.cfg["gblinear"]
        return GBLinearParams(eta=float(g["eta"]), reg_lambda=float(g["reg_lambda"]), reg_alpha=float(g["reg_alpha"]),
                              base_score=float(self.cfg["base_score"]), num_round=int(g["num_round"]),
                              block_size=int(g["block_size"]))

    def _matrices(self):
        return inputs.make_training(self.seed, int(self.traffic["rows"]), 10 * int(self.cfg["tracks"]),
                                    int(self.cfg["tissue_models"]), self.device)

    def flipped(self, i: int) -> np.ndarray:
        """The rows whose sign call ``i`` flips."""
        n = int(self.traffic["rows"])
        return np.sort(inputs.rng(self.seed, "flip", i).choice(n, int(self.traffic["flip_rows"]), replace=False))

    def setup(self) -> None:
        from expecto_tpu_torch.models.gblinear import train_gblinear_multi_sharded

        self._train = functools.partial(train_gblinear_multi_sharded, params=self._hp(), device=self.device)
        X, Y = self._matrices()
        self.X, self.Y = X.cpu().numpy(), Y.cpu().numpy()
        del X, Y
        self.mark("X and Y")
        self.warm(self._train, self.X, self.Y)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def call(self, i: int) -> None:
        rows = self.flipped(i)
        self.X[rows] *= -1.0
        res = self._train(self.X, self.Y)
        self.kept = [(i, res.weights, res.biases)]

    def free(self) -> None:
        del self.X, self.Y
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def check(self, control=None):
        g = self.cfg["gblinear"]
        last, w_p, b_p = self.kept[-1]
        X, Y = self._matrices()
        for i in range(last + 1):
            rows = torch.from_numpy(self.flipped(i)).to(X.device)
            X[rows] = -X[rows]
        kw = dict(eta=float(g["eta"]), reg_lambda=float(g["reg_lambda"]), reg_alpha=float(g["reg_alpha"]),
                  reg_lambda_bias=0.0, base_score=float(self.cfg["base_score"]), num_round=int(g["num_round"]),
                  block_size=int(g["block_size"]))
        w_ref, b_ref = (a.double().cpu().numpy() for a in ref_gblinear.train(X, Y, **kw))
        if control == "half_rows":
            # a fault: half the rows left out, the sums taken over the rest
            h = X.shape[0] // 2
            w_p, b_p = (a.double().cpu().numpy() for a in ref_gblinear.train(X[:h], Y[:h], **kw))
        elif control is not None:
            w_p, b_p = (a.double().cpu().numpy() for a in ref_gblinear.train(X, Y, precision=control, **kw))
        del X, Y
        # each model's scale: its largest weight, or the median model's
        # where that is larger (a model that barely moved)
        w_scale = np.abs(w_ref).max(axis=0)
        w_scale = np.maximum(w_scale, statistics.median(w_scale.tolist()))
        b_scale = np.maximum(np.abs(b_ref), statistics.median(np.abs(b_ref).tolist()))
        self._model_gaps = {
            "weight_gap": gap(w_p, w_ref, 1.0).max(axis=0) / np.maximum(w_scale, 1e-30),
            "bias_gap": gap(b_p, b_ref, 1.0) / np.maximum(b_scale, 1e-30),
        }
        return {k: float(v.max()) for k, v in self._model_gaps.items()}

    def failed_units(self, limits):
        bad = np.zeros(len(self._model_gaps["weight_gap"]), bool)
        for k, v in self._model_gaps.items():
            bad |= ~(v <= limits[k])
        return int(bad.sum())


FLOW = TrainFlow
