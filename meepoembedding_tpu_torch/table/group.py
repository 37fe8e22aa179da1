"""Named groups of dynamic tables (port of
`meepoembedding_tpu/table/group.py`).

A model may own several logical tables with their own dims, optimizers
and policies, one a feature family (user ids at dim 64, item ids at dim
32, ...). `TableGroup` holds independently configured
`DynamicEmbeddingTable`s behind one lookup, update and checkpoint surface.

Checkpoint layout, the reference's: <path>/group.json (the member names
and their subdirectories) and each member's checkpoint in
<path>/table-<name>/, so every member stays restorable on its own.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

from meepoembedding_tpu_torch.config import TableConfig
from meepoembedding_tpu_torch.table.runtime import DynamicEmbeddingTable


def write_group_json(path: str, manifest: dict) -> None:
    """<path>/group.json, written to a temporary file and renamed, as the
    reference does."""
    tmp = os.path.join(path, ".group.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, "group.json"))


def read_group_json(path: str, names) -> dict:
    """<path>/group.json; raises unless it lists exactly the members `names`."""
    with open(os.path.join(path, "group.json")) as f:
        manifest = json.load(f)
    if set(manifest["tables"]) != set(names):
        raise ValueError(f"group mismatch: checkpoint has {sorted(manifest['tables'])}, "
                         f"group has {sorted(names)}")
    return manifest


class TableGroup:
    def __init__(self, configs: Dict[str, TableConfig], spills: Optional[dict] = None,
                 device="cuda"):
        if not configs:
            raise ValueError("TableGroup needs at least one table")
        spills = spills or {}
        self.tables: Dict[str, DynamicEmbeddingTable] = {
            name: DynamicEmbeddingTable(cfg, device=device, spill=spills.get(name))
            for name, cfg in configs.items()
        }

    def __getitem__(self, name: str) -> DynamicEmbeddingTable:
        return self.tables[name]

    def __iter__(self):
        return iter(self.tables)

    def lookup(self, name: str, ids64, train: bool = True):
        return self.tables[name].lookup(ids64, train=train)

    def apply_grads(self, name: str, grads) -> None:
        return self.tables[name].apply_grads(grads)

    def remove(self, name: str, ids64) -> int:
        return self.tables[name].remove(ids64)

    def evict(self) -> Dict[str, int]:
        return {n: t.evict() for n, t in self.tables.items()}

    def counters(self) -> Dict[str, dict]:
        return {n: t.counters() for n, t in self.tables.items()}

    def __len__(self) -> int:
        return sum(len(t) for t in self.tables.values())

    # --- checkpoint (each member keeps its own format) -------------------------
    def save(self, path: str, extras: Optional[dict] = None) -> dict:
        os.makedirs(path, exist_ok=True)
        manifest = {"tables": {}, "extras": extras or {}}
        for name, t in self.tables.items():
            t.save(os.path.join(path, f"table-{name}"))
            manifest["tables"][name] = f"table-{name}"
        write_group_json(path, manifest)
        return manifest

    def load(self, path: str) -> dict:
        manifest = read_group_json(path, self.tables)
        for name, sub in manifest["tables"].items():
            self.tables[name].load(os.path.join(path, sub))
        return manifest
