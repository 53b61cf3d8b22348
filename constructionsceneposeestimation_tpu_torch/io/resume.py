"""Resume logic.

Two mechanisms:

* ``next_frame_index`` — the reference's scan of ``labels/label_(\\d+).json``
  for max+1 (generate_construction_data.py:1357-1367), kept for drop-in
  behavior.
* A shard manifest (``logs/manifest.json``) recording completed frame-id
  ranges — the batched generator's mechanism: per-seed determinism means
  any frame can be regenerated bit-identically, so resume = generate the
  complement.

A copy of the JAX package's ``io/resume.py``.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import List, Set, Tuple

_LABEL_RE = re.compile(r"label_(\d+)\.json")


def next_frame_index(labels_dir: str) -> int:
    """Reference semantics: max existing label index + 1, else 0."""
    existing = []
    p = Path(labels_dir)
    if p.exists():
        for f in p.glob("label_*.json"):
            m = _LABEL_RE.match(f.name)
            if m:
                existing.append(int(m.group(1)))
    return max(existing) + 1 if existing else 0


def manifest_path(root: str) -> str:
    return os.path.join(root, "logs", "manifest.json")


def load_manifest(root: str) -> Set[int]:
    path = manifest_path(root)
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        data = json.load(f)
    done: Set[int] = set()
    for lo, hi in data.get("completed_ranges", []):
        done.update(range(lo, hi))
    return done


def record_completed(root: str, frame_ids: List[int]) -> None:
    done = load_manifest(root)
    done.update(int(i) for i in frame_ids)
    ranges: List[Tuple[int, int]] = []
    for i in sorted(done):
        if ranges and ranges[-1][1] == i:
            ranges[-1] = (ranges[-1][0], i + 1)
        else:
            ranges.append((i, i + 1))
    os.makedirs(os.path.dirname(manifest_path(root)), exist_ok=True)
    with open(manifest_path(root), "w") as f:
        json.dump({"completed_ranges": [list(r) for r in ranges]}, f)


def pending_frames(root: str, total: int) -> List[int]:
    done = load_manifest(root)
    return [i for i in range(total) if i not in done]


def contiguous_chunks(frame_ids: List[int], batch: int) -> List[List[int]]:
    """Split ids into contiguous runs, each chunked to <= ``batch``.

    The generate pipeline's scene-cadence dedup gathers each frame's scene
    from a group window anchored at the batch's first id, so a batch MUST be
    a contiguous id run — a resume manifest with interior holes would
    otherwise silently render frames with a clamped edge group's scene."""
    chunks: List[List[int]] = []
    run: List[int] = []
    for fid in frame_ids:
        if run and fid != run[-1] + 1:
            chunks.extend(run[i:i + batch] for i in range(0, len(run), batch))
            run = []
        run.append(fid)
    if run:
        chunks.extend(run[i:i + batch] for i in range(0, len(run), batch))
    return chunks


def pending_chunks(root: str, total: int, batch: int) -> List[List[int]]:
    """Pending frames grouped into generate-safe contiguous batches."""
    return contiguous_chunks(pending_frames(root, total), batch)
