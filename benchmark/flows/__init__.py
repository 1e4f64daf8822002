"""The flows a traffic file can name (its ``"flow"`` key), one module each:
``benchmark/flows/<flow>.py`` defines ``FLOW``, a subclass of :class:`Flow`.
A flow builds its inputs from the seed, the program's entry as its CLI
builds it, warms it up on inputs of the same shapes, runs one call at a
time, keeps a sample of what the calls produced, and after the window
compares that sample with the plain reference.

- ``score``: ``pipeline.sed.score_sed_serving`` (``expecto-score``).
- ``genes``: ``pipeline.features.compute_gene_features``
  (``expecto-compute-features``).
- ``train``: ``models.gblinear.train_gblinear_multi_sharded``
  (``expecto-train``'s vectorized multi-tissue sweep).

A later cell of an existing flow needs only data files (a traffic mix, a
configuration); a new flow is a new file here.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .. import flops, inputs
from ..reference.beluga import Beluga


def dtype(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def gap(program: np.ndarray, reference: np.ndarray, scale: float) -> np.ndarray:
    """|program - reference| over ``scale``; a non-finite reading is inf."""
    d = np.abs(np.asarray(program, np.float64) - reference) / max(scale, 1e-30)
    return np.where(np.isfinite(d), d, np.inf)


def timed(fn, sink: list):
    """``fn`` with each call's host seconds appended to ``sink``."""

    @functools.wraps(fn)
    def wrapped(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            sink.append(time.perf_counter() - t0)

    return wrapped


class PoolExhausted(RuntimeError):
    """The window outran the inputs made in set-up."""


class Flow:
    """One cell's inputs, program entry and check. ``cfg`` and ``traffic``
    are the parsed configuration and traffic files; ``workdir`` a private
    directory for the run's files; ``cache_dir`` a fixed directory of the
    checkout for inputs that do not change from run to run.

    The harness calls :meth:`setup` (ending with one warm call on inputs of
    the timed shapes, its seconds in ``warm_s``), then :meth:`prepare` with
    the number of calls to make inputs for, then :meth:`call` for calls
    0, 1, ... A call past the prepared inputs raises :class:`PoolExhausted`:
    nothing is generated inside the window."""

    # units of work a call completes (variants, genes, boosting rounds)
    units_per_call = 1

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device, workdir: str, cache_dir: str):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, int(seed), device
        self.workdir, self.cache_dir = workdir, cache_dir
        self.kept: list = []  # what the calls produced, for the check
        self.marks: list = []  # (set-up step, time.time() at its end)
        self.warm_s = 0.0

    def mark(self, step: str) -> None:
        self.marks.append((step, time.time()))

    def warm(self, fn, *args) -> None:
        """The warm call: ``fn(*args)`` to its end on the device, timed."""
        t0 = time.perf_counter()
        fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warm_s = time.perf_counter() - t0
        self.mark("warm call")

    def work_per_call(self) -> flops.Work:
        raise NotImplementedError

    def setup(self) -> None:
        raise NotImplementedError

    def prepare(self, calls: int) -> None:
        """Make the inputs of calls 0 .. ``calls`` - 1."""

    def call(self, i: int) -> None:
        raise NotImplementedError

    def runner_methods(self):
        """(object, attribute names) of the program's device layer that the
        traced run times from the host."""
        return None, ()

    def program_functions(self):
        """(module, function names) of the program's host layer that the
        traced run's profiled stretch names idle gaps by."""
        return []

    def free(self) -> None:
        """Drop the program's state on the device."""

    def check(self, control: str | None = None) -> dict:
        """{number: value} comparing the kept sample with the reference, or
        with ``control`` (the reference in a lower precision, or with a
        fault planted) put in the program's place."""
        raise NotImplementedError

    def failed_units(self, limits: dict) -> int:
        """Sampled units (rows, genes, models) outside a limit, after
        :meth:`check`."""
        raise NotImplementedError


class PooledFlow(Flow):
    """A flow whose calls each take new inputs, made in set-up into
    ``self.pool`` by :meth:`make_input` (call index -> the call's input)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.pool: list = []

    def make_input(self, i: int):
        raise NotImplementedError

    def prepare(self, calls: int) -> None:
        while len(self.pool) < calls:
            self.pool.append(self.make_input(len(self.pool)))
        self.mark("inputs of the calls")

    def input(self, i: int):
        if i >= len(self.pool):
            raise PoolExhausted(f"call {i} outran the {len(self.pool)} inputs made in set-up")
        return self.pool[i]


class BelugaFlow(PooledFlow):
    """What the score and gene flows share: the genome, the weights, the
    runner as the CLIs build it."""

    def genome_and_fasta(self):
        from expecto_tpu_torch.genome.fasta import FastaIndex

        self.genome, path = inputs.cached_genome(self.traffic["genome"], self.cache_dir)
        self.fasta = FastaIndex(path)

    def build_runner(self):
        from expecto_tpu_torch.parallel.runner import BelugaRunner

        self.params = inputs.make_beluga(self.seed, self.cfg, self.device)
        self.runner = BelugaRunner(self.params, batch_size=int(self.traffic["batch_size"]), device=self.device,
                                   compute_dtype=dtype(self.cfg["compute_dtype"]),
                                   out_dtype=np.dtype(self.cfg["wire_dtype"]),
                                   pipeline_depth=int(self.traffic["pipeline_depth"]))
        self.mark("weights and runner")

    def runner_methods(self):
        names = [n for n in dir(type(self.runner)) if n.startswith(("score_", "predict_", "project_"))]
        return self.runner, names

    def free(self) -> None:
        self.fasta.close()
        del self.runner, self.params
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def reference_net(self, control: str | None) -> Beluga:
        params = inputs.make_beluga(self.seed, self.cfg, self.device)
        return Beluga(params, precision="fp8" if control == "fp8" else ("tf32" if control == "tf32" else "fp32"))
