"""Chunk-merge utilities (port of expecto_tpu/pipeline/merge.py): the
natural sort that orders consensus samples and genes. The mergers
themselves are not ported yet."""

from __future__ import annotations

import re


def natsorted(items):
    """Natural sort (replacement for the natsort dependency)."""

    def key(s):
        return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", str(s))]

    return sorted(items, key=key)
