"""Per-shard work manifests: idempotent resume for sharded batch runs (port
of expecto_tpu/utils/manifest.py).

The reference's recovery is skip-if-output-exists file sentinels
(geuvadis_predict_consensus.py:79-82) and merge count asserts. A manifest is
the structured equivalent: a JSON file records every work item's state and
output path; a restarted run (same or another host) reruns only the missing
or failed items, and mergers can check completeness against the manifest
instead of counting globs. The file format is the JAX package's.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path


class ShardManifest:
    """Append-only item tracker backed by a JSON file.

    Usage:
        m = ShardManifest(out_dir / "manifest.json", items=gene_ids)
        for item in m.pending():
            ... compute ...
            m.mark_done(item, output=str(path))
    """

    def __init__(self, path: str | os.PathLike, items: list[str] | None = None):
        self.path = Path(path)
        if self.path.exists():
            self._state = json.loads(self.path.read_text())
            if items is not None:
                added = False
                for it in items:
                    if str(it) not in self._state:
                        self._state[str(it)] = {"status": "pending"}
                        added = True
                if added:
                    # persist merged-in items now: a crash before any
                    # mark_done must leave them visible as pending, or a
                    # later reader without items would call the run complete
                    self._flush()
        else:
            self._state = {str(it): {"status": "pending"} for it in (items or [])}
            self._flush()

    def _flush(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self._state, indent=0))
        os.replace(tmp, self.path)

    def pending(self) -> list[str]:
        return [k for k, v in self._state.items() if v.get("status") != "done"]

    def done(self) -> list[str]:
        return [k for k, v in self._state.items() if v.get("status") == "done"]

    def mark_done(self, item: str, output: str | None = None) -> None:
        self._state[str(item)] = {"status": "done", "output": output, "t": time.time()}
        self._flush()

    def mark_failed(self, item: str, error: str) -> None:
        self._state[str(item)] = {"status": "failed", "error": error, "t": time.time()}
        self._flush()

    def is_complete(self) -> bool:
        return not self.pending()

    def verify_outputs(self) -> list[str]:
        """Items marked done whose output file is missing (e.g. a lost shard)."""
        missing = []
        for k, v in self._state.items():
            if v.get("status") == "done" and v.get("output") and not os.path.exists(v["output"]):
                missing.append(k)
        return missing
