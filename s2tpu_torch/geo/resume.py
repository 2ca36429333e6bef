"""Crash-resume protocol for the download pipelines: the port of ``s2tpu/geo/resume.py``.

Parity with reference download_sentinel.py:122-145: a ``resume.json`` with
completed segment indices, plus a ``metadata.tmp.json`` settings snapshot
whose equality gates resumption (resuming under changed parameters is an
error, not a silent mix of datasets).
"""

from __future__ import annotations

import json
from pathlib import Path


class ResumeState:
    def __init__(self, base_path: Path, current_metadata: dict) -> None:
        self.resume_file = base_path / "resume.json"
        self.metadata_file = base_path / "metadata.tmp.json"
        self.final_metadata_file = base_path / "metadata.json"
        self.metadata = current_metadata
        self.done: set[int] = set()

    def load(self) -> set[int]:
        """Load completed indices; asserts metadata equality with the prior run."""
        if self.resume_file.exists():
            self.done = set(json.loads(self.resume_file.read_text()).get("skip_indices", []))
            if self.metadata_file.exists():
                previous = json.loads(self.metadata_file.read_text())
                if previous != self.metadata:
                    raise RuntimeError(
                        "Resume metadata mismatch — the previous download ran with different "
                        f"settings.\ncurrent:  {self.metadata}\nprevious: {previous}"
                    )
        self.metadata_file.parent.mkdir(parents=True, exist_ok=True)
        self.metadata_file.write_text(json.dumps(self.metadata, indent=4))
        return set(self.done)

    def mark_done(self, idx: int) -> None:
        self.done.add(idx)
        self.resume_file.write_text(json.dumps({"skip_indices": sorted(self.done)}, indent=4))

    def finalize(self) -> None:
        """Write the permanent metadata record and clear resume state."""
        self.final_metadata_file.write_text(json.dumps(self.metadata, indent=4))
        self.resume_file.unlink(missing_ok=True)
        self.metadata_file.unlink(missing_ok=True)
